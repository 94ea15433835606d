"""Relativistic RK4 integrator with the reference's exact stage dataflow.

The reference integrates with five compute dispatches
(reference: src/twoplusone/softbody/mod.rs:628-702, stages at
softbodyrk4.glsl:168-255).  Its scheme is *not* textbook RK4 — parity
requires mirroring these deliberate quirks:

  * Every stage's acceleration uses the ORIGINAL velocity, not the
    intermediate one: `r_acc(forces, original_particles[i].ground_vel, ...)`
    (softbodyrk4.glsl:174, 187, 200, 223).
  * Intermediate positions advance with the *newly updated* velocity
    (semi-implicit flavor): `new_vel = orig_vel + a*h/2; pos = orig_pos +
    new_vel*h/2` (softbodyrk4.glsl:175-177).
  * Only FORCES are accumulated (f0 + 2 f1 + 2 f2 + f3); the final combine is
    `vel = orig_vel + r_acc(facc, orig_vel)*h/6; pos = orig_pos + vel*h`
    (softbodyrk4.glsl:222-230) — position is NOT the k-weighted combination.
  * After the combine, |v| >= c is clamped to 0.9999 c
    (softbodyrk4.glsl:227).
  * Bonds whose length *at the start-of-step positions* exceeds the break
    threshold are removed symmetrically (softbodyrk4.glsl:233-253).
    Intermediate stages see the pre-break bond table
    (propagate_breaking, softbodyrk4.glsl:148-151).

All five stages share one collision-candidate set built from start-of-step
positions, exactly like the reference reusing last frame's grid for the whole
RK4 (SURVEY.md §3.3).  In JAX the reference's two aliased intermediate
buffers and force accumulator (softbody/mod.rs:345-392) simply disappear —
the dataflow below IS the descriptor-set wiring.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import relativity
from ..constants import PhysicsParams
from ..state import Particles
from . import forces as forces_ops
from . import grid as grid_ops


class StepAux(NamedTuple):
    """Per-step diagnostics (the analog of the reference's GPU timestamps +
    validation layer, querybank.rs / boilerplate.rs:466-533)."""

    grid_overflow: jax.Array  # candidates dropped by cell-capacity cap
    bonds_broken: jax.Array  # bonds removed this step (directed count)


def _advance(pos0, vel0, forces, rest_mass, h_scale, params: PhysicsParams):
    """One intermediate-state update (softbodyrk4.glsl:174-177 pattern):
    acceleration from ORIGINAL velocity, position from the NEW velocity."""
    acc = relativity.r_acc(forces, vel0, rest_mass)
    new_vel = vel0 + acc * h_scale
    new_pos = pos0 + new_vel * h_scale
    return new_pos, new_vel


def break_bonds(pos, neighbors, threshold, break_scale=None):
    """Symmetric bond breaking from current positions
    (softbodyrk4.glsl:233-253).

    The reference scatter-writes the reciprocal slot of the far endpoint;
    because the import wires every bond symmetrically
    (reference: softbody/mod.rs:162-187) and distance is symmetric, a pure
    gather — each endpoint re-evaluating its own slots — removes exactly the
    same set of bonds with no scatter.

    `break_scale` (N,) optionally scales the threshold per particle
    (ops/materials.py); the pair takes the endpoint MIN so both endpoints
    agree (the weaker material fails first) and breaking stays symmetric.
    """
    n = pos.shape[0]
    valid = neighbors >= 0
    clipped = jnp.clip(neighbors, 0, n - 1)
    nbr_pos = pos[clipped]
    dist = jnp.linalg.norm(pos[:, None, :] - nbr_pos, axis=-1)
    thr = threshold
    if break_scale is not None:
        thr = threshold * jnp.minimum(break_scale[:, None], break_scale[clipped])
    broke = valid & (dist > thr)
    return jnp.where(broke, -1, neighbors), jnp.sum(broke.astype(jnp.int32))


def break_bonds_shifted(pos, neighbors, offsets, threshold, break_scale=None):
    """break_bonds with bonded positions read by static shifted slices (same
    masking rule as forces.spring_forces_shifted) — no (N, 8, 2) gather."""
    px, py = pos[:, 0], pos[:, 1]
    n = px.shape[0]
    iota = jnp.arange(n, dtype=neighbors.dtype)
    cols = []
    n_broken = jnp.int32(0)
    for s, ds in enumerate(offsets):
        col = neighbors[:, s]
        bonded = col >= 0  # the -1 sentinel would match iota + d at
        # i == -1 - d, inflating bonds_broken with phantom pairs
        broke_s = jnp.zeros((n,), bool)
        for d in ds:
            sel = bonded & (col == iota + d)
            dx = px - jnp.roll(px, -d)
            dy = py - jnp.roll(py, -d)
            dist = jnp.sqrt(dx * dx + dy * dy)
            thr = threshold
            if break_scale is not None:
                thr = threshold * jnp.minimum(
                    break_scale, jnp.roll(break_scale, -d)
                )
            broke_s = broke_s | (sel & (dist > thr))
        cols.append(jnp.where(broke_s, -1, col))
        n_broken = n_broken + jnp.sum(broke_s.astype(jnp.int32))
    return jnp.stack(cols, axis=1), n_broken


def rk4_step(
    particles: Particles,
    params: PhysicsParams,
    rest_lengths: jax.Array,
    cand_idx: jax.Array,
    cand_valid: jax.Array,
) -> tuple[Particles, jax.Array]:
    """One RK4 step given a prebuilt candidate set. Returns (state, bonds_broken)."""
    h = params.h
    pos0, vel0 = particles.pos, particles.vel
    nbr, m = particles.neighbors, particles.rest_mass
    if particles.rest_len is not None:  # plastic-creep state overrides slots
        rest_lengths = particles.rest_len

    def F(pos):
        return forces_ops.total_forces(pos, nbr, cand_idx, cand_valid, rest_lengths, params)

    # RK4STAGE_0 (softbodyrk4.glsl:168-180)
    f0 = F(pos0)
    p1, _ = _advance(pos0, vel0, f0, m, h / 2.0, params)
    # RK4STAGE_1 (:181-193)
    f1 = F(p1)
    p2, _ = _advance(pos0, vel0, f1, m, h / 2.0, params)
    # RK4STAGE_2 (:194-204)
    f2 = F(p2)
    p3, _ = _advance(pos0, vel0, f2, m, h, params)
    # RK4STAGE_3 (:206-213) — forces only
    f3 = F(p3)
    facc = f0 + 2.0 * f1 + 2.0 * f2 + f3
    # RK4STAGE_4 (:214-255) — combine, clamp, break bonds
    acc = relativity.r_acc(facc, vel0, m)
    vel = vel0 + acc * (h / 6.0)
    speed = jnp.linalg.norm(vel, axis=-1, keepdims=True)
    vel = jnp.where(
        speed >= 1.0, vel / jnp.maximum(speed, 1e-20) * params.max_speed, vel
    )
    pos = pos0 + vel * h
    new_neighbors, n_broken = break_bonds(pos0, nbr, params.bond_break_threshold)

    act = particles.active[:, None]
    new = Particles(
        pos=jnp.where(act, pos, pos0),
        vel=jnp.where(act, vel, vel0),
        rest_mass=particles.rest_mass,
        neighbors=new_neighbors,
        object_index=particles.object_index,
        particle_id=particles.particle_id,
        active=particles.active,
        rest_len=particles.rest_len,
    )
    return new, n_broken


def euler_step(
    particles: Particles,
    params: PhysicsParams,
    rest_lengths: jax.Array,
    cand_idx: jax.Array,
    cand_valid: jax.Array,
) -> Particles:
    """The reference's deprecated Euler path ("strictly worse than rk4",
    reference: softbody/mod.rs:598-626; kernel softbodyrk4.glsl:155-165).
    Note position advances with the OLD velocity; no clamp, no bond breaking.
    """
    if particles.rest_len is not None:  # plastic-creep state overrides slots
        rest_lengths = particles.rest_len
    f = forces_ops.total_forces(
        particles.pos, particles.neighbors, cand_idx, cand_valid, rest_lengths, params
    )
    acc = relativity.r_acc(f, particles.vel, particles.rest_mass)
    act = particles.active[:, None]
    return Particles(
        pos=jnp.where(act, particles.pos + particles.vel * params.h, particles.pos),
        vel=jnp.where(act, particles.vel + acc * params.h, particles.vel),
        rest_mass=particles.rest_mass,
        neighbors=particles.neighbors,
        object_index=particles.object_index,
        particle_id=particles.particle_id,
        active=particles.active,
        rest_len=particles.rest_len,
    )


def physics_step(
    particles: Particles,
    params: PhysicsParams,
    rest_lengths: jax.Array,
    grid_dim: int,
    cell_capacity: int,
    integrator: str = "rk4",
    spring_offsets=None,
    materials=None,  # ops.materials.ParticleMaterials (optional pytree)
) -> tuple[Particles, StepAux]:
    """Full per-frame physics: cell-table rebuild + integrate.

    The analog of `submit_per_frame_compute` (reference:
    src/twoplusone/softbody/mod.rs:557-596): the binning is built once from
    the step's starting positions and shared by all five force evaluations
    (only the position planes are re-scattered per stage).
    """
    h = params.h
    pos0, vel0 = particles.pos, particles.vel
    nbr, m = particles.neighbors, particles.rest_mass
    # per-bond rest lengths (plastic creep state) override the static slot
    # constants when present
    if particles.rest_len is not None:
        rest_lengths = particles.rest_len

    table = grid_ops.build_cell_table(
        pos0, particles.active, params.grid_resolution, grid_dim,
        cell_capacity,
    )
    grid_overflow = table.overflow
    ncell = grid_ops.neighbor_cells(table, grid_dim)  # (N, 9)
    idx_nbr = table.idx_rows[ncell]  # (N, 9, cap) — fixed per step

    def F(pos):
        return forces_ops.total_forces_cells(
            pos, nbr, table, ncell, idx_nbr, rest_lengths, params,
            materials=materials, vel0=vel0,
        )

    if integrator == "euler":
        f = F(pos0)
        acc = relativity.r_acc(f, vel0, m)
        act = particles.active[:, None]
        new = Particles(
            pos=jnp.where(act, pos0 + vel0 * h, pos0),
            vel=jnp.where(act, vel0 + acc * h, vel0),
            rest_mass=m,
            neighbors=nbr,
            object_index=particles.object_index,
            particle_id=particles.particle_id,
            active=particles.active,
            rest_len=particles.rest_len,
        )
        return new, StepAux(grid_overflow=grid_overflow,
                            bonds_broken=jnp.int32(0))
    if integrator != "rk4":
        raise ValueError(f"unknown integrator: {integrator}")

    # RK4STAGE_0..4 (softbodyrk4.glsl:168-255) — see rk4_step for the scheme
    f0 = F(pos0)
    p1, _ = _advance(pos0, vel0, f0, m, h / 2.0, params)
    f1 = F(p1)
    p2, _ = _advance(pos0, vel0, f1, m, h / 2.0, params)
    f2 = F(p2)
    p3, _ = _advance(pos0, vel0, f2, m, h, params)
    f3 = F(p3)
    facc = f0 + 2.0 * f1 + 2.0 * f2 + f3
    acc = relativity.r_acc(facc, vel0, m)
    vel = vel0 + acc * (h / 6.0)
    speed = jnp.linalg.norm(vel, axis=-1, keepdims=True)
    vel = jnp.where(speed >= 1.0, vel / jnp.maximum(speed, 1e-20) * params.max_speed, vel)
    pos = pos0 + vel * h
    brk_pp = materials.break_scale if materials is not None else None
    if spring_offsets is not None:
        new_neighbors, n_broken = break_bonds_shifted(
            pos0, nbr, spring_offsets, params.bond_break_threshold,
            break_scale=brk_pp,
        )
    else:
        new_neighbors, n_broken = break_bonds(
            pos0, nbr, params.bond_break_threshold, break_scale=brk_pp
        )

    # plastic creep (stage-4 state update, like bond breaking): bonds
    # stretched past their yield strain at the step's START positions
    # permanently lengthen toward the current length
    new_rest = particles.rest_len
    if (
        materials is not None
        and getattr(materials, "creep_rate", None) is not None
        and new_rest is None
    ):
        # Auto-initializing here would change the output pytree structure
        # (breaking lax.scan carries and sharded-step in_shardings), so
        # surface the misconfiguration loudly instead — trace-time only.
        from ..utils import logging as stlog

        stlog.get().warning(
            "materials.creep_rate is set but particles.rest_len is None; "
            "plastic creep is DISABLED — call state.with_rest_len(particles, "
            "params.rest_lengths) before stepping"
        )
    if (
        materials is not None
        and getattr(materials, "creep_rate", None) is not None
        and new_rest is not None
    ):
        new_rest = forces_ops.creep_rest_lengths_shifted(
            pos0[:, 0], pos0[:, 1], nbr, spring_offsets, new_rest,
            materials.creep_rate, materials.yield_strain, h,
        ) if spring_offsets is not None else forces_ops.creep_rest_lengths_rows(
            pos0, nbr, new_rest, materials.creep_rate,
            materials.yield_strain, h,
        )

    act = particles.active[:, None]
    new = Particles(
        pos=jnp.where(act, pos, pos0),
        vel=jnp.where(act, vel, vel0),
        rest_mass=m,
        neighbors=new_neighbors,
        object_index=particles.object_index,
        particle_id=particles.particle_id,
        active=particles.active,
        rest_len=new_rest,
    )
    return new, StepAux(grid_overflow=grid_overflow, bonds_broken=n_broken)
