"""Sharded step/render: multi-chip execution of the full frame.

GSPMD sharding layout (see parallel/__init__ for the mapping rationale):
  * Particles pytree: every (N, ...) array sharded on the capacity axis.
    Forces/integration are row-parallel; the collision-grid sort and the
    neighbor/candidate gathers become XLA collectives between devices.
  * Worldline ring buffer: the time-major (2T, N) planes are sharded on
    the PARTICLE axis (dim 1) — the SAME axis as the physics state, so
    `push_frame` writes its tick row shard-locally with no resharding, and
    the renderer's cone sweep / window extraction stay particle-parallel.
    (A history-axis layout was considered and rejected: every per-tick push
    would cut across all shards.)  `times (T,)` and the cursor are
    replicated.
  * Image: sharded on pixel rows (pure data parallel).

tests/test_parallel.py asserts the installed PartitionSpecs on the frame
OUTPUTS and that the compiled HLO contains no full all-gather of the ring
planes (collective-cost guard), in addition to numerical equality with the
single-device frame.

The entry points return jitted functions with in/out shardings bound, so the
driver can run one training-step-equivalent (step + worldline push + render)
over an N-device mesh.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..camera import Camera
from ..models.softbody import SoftbodyModel
from ..ops import raytrace
from ..ops import worldline as wl
from ..state import Objects, Particles


def particle_sharding(mesh: Mesh, axis: str = "d", with_rest_len=False):
    """Shardings for the Particles pytree: shard the capacity axis.
    `with_rest_len=True` when the state carries the plastic-creep rest-length
    plane (the pytrees must have matching structure)."""
    row = NamedSharding(mesh, P(axis))
    return Particles(
        pos=row, vel=row, rest_mass=row, neighbors=row,
        object_index=row, particle_id=row, active=row,
        rest_len=row if with_rest_len else None,
    )


def worldline_sharding(mesh: Mesh, axis: str = "d"):
    """Shardings for the ring buffer: the time-major (2T, N) planes shard
    on the PARTICLE axis (dim 1) — matching the Particles sharding so pushes
    and the renderer's per-particle band sweep are shard-local; times/cursor
    are replicated (every shard needs the clock)."""
    plane = NamedSharding(mesh, P(None, axis))
    rep = NamedSharding(mesh, P())
    return wl.WorldlineBuffer(
        pos_x=plane, pos_y=plane, vel_x=plane, vel_y=plane,
        times=rep, cursor=rep, frames_in_use=rep,
    )


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())


def shard_state(particles: Particles, buf: wl.WorldlineBuffer, mesh: Mesh, axis="d"):
    """Place existing host/device state onto the mesh."""
    p = jax.device_put(
        particles,
        particle_sharding(mesh, axis,
                          with_rest_len=particles.rest_len is not None),
    )
    b = jax.device_put(buf, worldline_sharding(mesh, axis))
    return p, b


def make_sharded_frame(
    model: SoftbodyModel,
    objects: Objects,
    render_params: raytrace.RenderParams,
    width: int,
    height: int,
    mesh: Mesh,
    axis: str = "d",
    materials=None,  # ops.materials.ParticleMaterials (replicated)
    render_mode: str = "retarded",  # retarded | conical | btz | points | worldline3d
    defects=None,  # conical: quasi-static defect tuple(s) (replicated)
    hole=None,  # btz: ops.btz.BTZBlackHole (replicated)
    defect_source=None,  # conical: matter-sourced specs (ops/gravity)
    defect_g: float = 0.0,
    defect_retarded: bool = False,  # conical: sourced defects on the past cone
    wl3d=None,  # worldline3d: utils.config.Worldline3DParams
):
    """One fused frame — physics step + worldline push + retarded render —
    jitted over the mesh: particles and ring planes shard on the particle
    axis, the image on pixel rows.  Returns
    fn(particles, buf, cam, time) -> (particles, buf, img).

    Everything here is plain XLA that GSPMD partitions: the pixel pass runs
    the XLA block map (an unsharded kernel call inside the partitioned jit
    would see shard-local shapes).

    `render_mode` extends multi-chip to the curved spacetimes: "conical"
    renders through ops.curved with the given `defects` ("retarded" sourced
    placement via `defect_retarded=True` — the ring reductions become psums),
    "btz" through ops.btz with the given `hole`; GSPMD shards their pair
    tables over the particle axis.  "points" uses the XLA scatter
    rasterizer; "worldline3d" is an XLA scatter-min projection.

    For time-dependent defect motion, interactive control and diagnostics
    adaptation on a mesh, construct `Engine(config, mesh=...)` instead —
    the Engine is mesh-native and drives this same layout.
    """
    if render_mode == "conical" and defects is None and defect_source is None:
        raise ValueError("render_mode='conical' requires defects or "
                         "defect_source")
    if render_mode == "btz" and hole is None:
        raise ValueError("render_mode='btz' requires hole")
    if render_mode == "worldline3d" and wl3d is None:
        raise ValueError("render_mode='worldline3d' requires wl3d params")
    render_params = dataclasses.replace(render_params, backend="xla")
    wrl = materials is not None and getattr(materials, "creep_rate", None) is not None
    p_shard = particle_sharding(mesh, axis, with_rest_len=wrl)
    b_shard = worldline_sharding(mesh, axis)
    rep = replicated(mesh)
    img_shard = NamedSharding(mesh, P(axis))  # rows of the image

    def frame(particles: Particles, buf: wl.WorldlineBuffer, cam: Camera, t):
        particles, aux = model.step(particles, materials)
        buf = wl.push_frame(buf, particles, t)
        if render_mode == "conical":
            from ..ops import curved

            if defects is None:
                all_defects = ()
            elif isinstance(defects, (tuple, list)):
                all_defects = tuple(defects)
            else:
                all_defects = (defects,)  # single ConicalDefect spec
            if defect_source:
                # matter-sourced defects compute in-graph from the sharded
                # state: the centroid reductions become psums over the mesh
                from ..ops import gravity

                all_defects = all_defects + gravity.source_defects(
                    defect_source, particles, buf, cam,
                    float(model.params.h), defect_g,
                    retarded=defect_retarded,
                    max_age=render_params.max_age,
                )
            img = curved.render_retarded_conical(
                buf, particles.object_index, objects, cam, all_defects,
                width, height, render_params,
            )
        elif render_mode == "btz":
            from ..ops import btz as btz_ops

            img, _diag = btz_ops.render_btz_with_diag(
                buf, particles.object_index, objects, cam, hole,
                width, height, render_params,
            )
        elif render_mode == "points":
            from ..ops import rasterize

            img = rasterize.render_points(
                particles, objects, cam, width, height
            )
        elif render_mode == "worldline3d":
            from ..ops import worldline3d

            img = worldline3d.render_worldline3d(
                buf, particles.object_index, objects, cam, width, height,
                wl3d, active=particles.active,
                boundary=wl.boundary_mask(particles),
            )
        else:
            img = raytrace.render_retarded(
                buf, particles.object_index, objects, cam,
                width, height, render_params,
            )
        return particles, buf, img

    cam_shard = Camera(pos=rep, zoom=rep, vel=rep)
    return jax.jit(
        frame,
        in_shardings=(p_shard, b_shard, cam_shard, rep),
        out_shardings=(p_shard, b_shard, img_shard),
    )


def make_sharded_step(model: SoftbodyModel, mesh: Mesh, axis: str = "d",
                      materials=None):
    """Physics-only sharded step (no renderer), for scaling the simulation.
    `materials` (per-particle planes) is closed over and replicated."""
    wrl = materials is not None and getattr(materials, "creep_rate", None) is not None
    p_shard = particle_sharding(mesh, axis, with_rest_len=wrl)

    def step(particles: Particles):
        new, aux = model.step(particles, materials)
        return new

    return jax.jit(step, in_shardings=(p_shard,), out_shardings=p_shard)
