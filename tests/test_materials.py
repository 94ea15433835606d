"""Per-object materials: stiffness scale, bond damping, break-threshold scale.

No reference analog (the reference's material_index only shades,
src/twoplusone/softbody/mod.rs:191-221); the physics semantics under test are
this engine's: pairwise-mean stiffness/damping (symmetric — momentum
conserving), pairwise-min break scale (weaker material fails first).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from spacetime_tpu import scene
from spacetime_tpu.constants import DEFAULT_PARAMS
from spacetime_tpu.models.softbody import SoftbodyModel
from spacetime_tpu.ops import forces as forces_ops
from spacetime_tpu.ops import materials as materials_ops
from spacetime_tpu.ops import rk4 as rk4_ops


def _two_blob(pad=True):
    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(4, 0, (0.0, 0.0), (0.05, 0.0), lattice_pad=pad),
           material_index=0)
    sb.add(scene.disc_softbody(4, 1, (0.08, 0.0), (-0.05, 0.0), lattice_pad=pad),
           material_index=1)
    return sb.build(capacity=512)


def _mats(p, objects, table):
    return materials_ops.particle_materials(
        table, objects.material_index, p.object_index
    )


def test_default_table_collapses_to_none():
    p, objects = _two_blob()
    assert _mats(p, objects, [(1.0, 0.0, 1.0), (1.0, 0.0, 1.0)]) is None


def test_default_materials_match_material_free_step():
    p, objects = _two_blob()
    model = SoftbodyModel(capacity=p.capacity)
    # explicit near-default planes (not collapsed to None) must not change
    # the trajectory
    mats = materials_ops.ParticleMaterials(
        k_scale=jnp.ones(p.capacity), damping=jnp.zeros(p.capacity),
        break_scale=jnp.ones(p.capacity),
    )
    a, _ = model.step(p)
    b, _ = model.step(p, mats)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                               rtol=1e-6, atol=1e-8)


def test_k_scale_halves_spring_force_shifted():
    p, objects = _two_blob()
    offsets = forces_ops.derive_spring_offsets(np.asarray(p.neighbors))
    rest = jnp.asarray(DEFAULT_PARAMS.rest_lengths())
    # stretch the lattice slightly so springs are loaded
    pos = p.pos * 1.01
    px, py = pos[:, 0], pos[:, 1]
    fx1, fy1 = forces_ops.spring_forces_shifted(
        px, py, p.neighbors, offsets, rest, DEFAULT_PARAMS.k
    )
    half = jnp.full((p.capacity,), 0.5)
    fx2, fy2 = forces_ops.spring_forces_shifted(
        px, py, p.neighbors, offsets, rest, DEFAULT_PARAMS.k, k_pp=half
    )
    act = np.asarray(p.active)
    np.testing.assert_allclose(np.asarray(fx2)[act], 0.5 * np.asarray(fx1)[act],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(fy2)[act], 0.5 * np.asarray(fy1)[act],
                               rtol=1e-5, atol=1e-6)
    assert np.abs(np.asarray(fx1)[act]).max() > 1.0


def test_rows_path_matches_shifted_with_materials(rng):
    p, objects = _two_blob()
    offsets = forces_ops.derive_spring_offsets(np.asarray(p.neighbors))
    rest = jnp.asarray(DEFAULT_PARAMS.rest_lengths())
    pos = p.pos * 1.005
    vel = jnp.asarray(
        rng.uniform(-0.05, 0.05, (p.capacity, 2)).astype(np.float32)
    )
    mats = _mats(p, objects, [(1.0, 0.0, 1.0), (0.5, 3.0, 0.7)])
    px, py = pos[:, 0], pos[:, 1]
    sfx, sfy = forces_ops.spring_forces_shifted(
        px, py, p.neighbors, offsets, rest, DEFAULT_PARAMS.k,
        k_pp=mats.k_scale,
    )
    dfx, dfy = forces_ops.bond_damping_shifted(
        px, py, vel[:, 0], vel[:, 1], p.neighbors, offsets, mats.damping
    )
    rfx, rfy = forces_ops.spring_forces_rows(
        px, py, p.neighbors, rest, DEFAULT_PARAMS.k,
        k_pp=mats.k_scale, c_pp=mats.damping, vx=vel[:, 0], vy=vel[:, 1],
    )
    act = np.asarray(p.active)
    np.testing.assert_allclose(
        np.asarray(sfx + dfx)[act], np.asarray(rfx)[act], rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(sfy + dfy)[act], np.asarray(rfy)[act], rtol=1e-4, atol=1e-4
    )


def test_damping_dissipates_bond_oscillation():
    # two bonded particles pulled apart: with damping the relative velocity
    # decays faster than without
    pos = np.full((8, 2), 1e9, np.float32)
    vel = np.zeros((8, 2), np.float32)
    nbr = np.full((8, 8), -1, np.int32)
    pos[0], pos[1] = (0.0, 0.0), (DEFAULT_PARAMS.rest_lengths()[0], 0.0)
    vel[0], vel[1] = (-0.02, 0.0), (0.02, 0.0)  # separating along the bond
    nbr[0, 0], nbr[1, 1] = 1, 0  # slot layout: 0 = +x neighbor, 1 = -x
    from spacetime_tpu.state import pack_particles

    p = pack_particles(pos[:2], vel[:2], nbr[:2],
                       np.zeros(2, np.int32), capacity=8)
    model = SoftbodyModel(capacity=8)
    mats = materials_ops.ParticleMaterials(
        k_scale=jnp.ones(8), damping=jnp.full((8,), 5.0),
        break_scale=jnp.ones(8),
    )

    rest = float(DEFAULT_PARAMS.rest_lengths()[0])
    k = DEFAULT_PARAMS.k

    def oscillation_energy(m, steps=25):
        # phase-invariant: reduced-mass kinetic + spring potential energy
        q = p
        for _ in range(steps):
            q, _ = model.step(q, m)
        v, x = np.asarray(q.vel), np.asarray(q.pos)
        vrel = v[1, 0] - v[0, 0]
        stretch = abs(x[1, 0] - x[0, 0]) - rest
        return 0.5 * 0.5 * vrel**2 + 0.5 * k * stretch**2

    undamped = oscillation_energy(None)
    damped = oscillation_energy(mats)
    assert damped < 0.5 * undamped


def test_break_scale_pairwise_min_breaks_weak_object_first():
    params = DEFAULT_PARAMS
    rest0 = params.rest_lengths()[0]
    # bond stretched to 93% of the break threshold: survives at scale 1.0,
    # breaks when either endpoint scales the threshold below 0.93
    stretch = 0.93 * params.bond_break_threshold
    pos = jnp.asarray([[0.0, 0.0], [stretch, 0.0]], jnp.float32)
    nbr = jnp.asarray([[1, -1, -1, -1, -1, -1, -1, -1],
                       [0, -1, -1, -1, -1, -1, -1, -1]], jnp.int32)
    ones = jnp.ones((2,))
    kept, n = rk4_ops.break_bonds(pos, nbr, params.bond_break_threshold,
                                  break_scale=ones)
    assert int(n) == 0
    weak = jnp.asarray([1.0, 0.8])  # endpoint 1 is the weaker material
    kept, n = rk4_ops.break_bonds(pos, nbr, params.bond_break_threshold,
                                  break_scale=weak)
    assert int(n) == 2  # symmetric: BOTH directed slots removed
    assert int(kept[0, 0]) == -1 and int(kept[1, 0]) == -1


def test_engine_materials_config_end_to_end():
    """config.materials reaches the fused frame: a soft+damped material
    changes the trajectory vs the default engine."""
    from spacetime_tpu.engine import Engine
    from spacetime_tpu.utils.config import EngineConfig, SceneSpec
    from spacetime_tpu.ops.raytrace import RenderParams

    def build(materials):
        cfg = EngineConfig(
            scene=SceneSpec(
                bodies=(
                    # close + fast: springs must actually load (materials
                    # are invisible while the lattice sits at rest length)
                    ("disc", 30, (0.0, 0.0), (0.2, 0.0), (0.2, 0.2, 1.0)),
                    ("disc", 30, (0.05, 0.002), (-0.2, 0.0), (1.0, 0.2, 0.2)),
                ),
                capacity=256,
            ),
            render=RenderParams(num_rays=256),
            width=32, height=32, history=16,
            materials=materials,
        )
        return Engine(cfg)

    # material 0 = default; both objects use index 0 by default, so a
    # non-default row 0 must change the dynamics
    soft = ((0.4, 2.0, 1.0),)
    eng_a = build(None)
    eng_b = build(soft)
    assert eng_a.materials is None
    assert eng_b.materials is not None
    for _ in range(40):
        eng_a.run_frame()
        eng_b.run_frame()
    pa = np.asarray(eng_a.particles.pos)[np.asarray(eng_a.particles.active)]
    pb = np.asarray(eng_b.particles.pos)[np.asarray(eng_b.particles.active)]
    assert np.abs(pa - pb).max() > 1e-5  # materials changed the trajectory


# ---------------------------------------------------------------------------
# Plastic creep (per-bond rest-length state, round 3)
# ---------------------------------------------------------------------------


def test_creep_closed_form_one_step():
    """One creep update matches R' = R + c*h*max(0, L - R*(1+y)) exactly
    (rows path), and the shifted path agrees."""
    from spacetime_tpu.state import pack_particles, with_rest_len

    # 1x2 lattice: one horizontal bond, stretched to 2x rest length
    rest = DEFAULT_PARAMS.rest_lengths()
    L = 2.0 * rest[0]
    pos = np.array([[0.0, 0.0], [L, 0.0]], np.float32)
    vel = np.zeros_like(pos)
    nbr = np.full((2, 8), -1, np.int32)
    nbr[0, 2] = 1  # right bond
    nbr[1, 0] = 0  # left bond (reciprocal)
    p = pack_particles(pos, vel, nbr, np.zeros(2, np.int32), capacity=256)
    p = with_rest_len(p, rest)
    c, y, h = 3.0, 0.25, DEFAULT_PARAMS.h
    rate = jnp.full((256,), c)
    ystr = jnp.full((256,), y)

    new_rows = forces_ops.creep_rest_lengths_rows(
        p.pos, p.neighbors, p.rest_len, rate, ystr, h
    )
    expect = rest[0] + c * h * max(0.0, L - rest[0] * (1.0 + y))
    assert np.isclose(float(new_rows[0, 2]), expect, rtol=1e-6)
    assert np.isclose(float(new_rows[1, 0]), expect, rtol=1e-6)  # symmetric
    # unstretched slots unchanged
    assert np.allclose(np.asarray(new_rows[0, [0, 1, 3]]),
                       rest[[0, 1, 3]], rtol=1e-7)

    offsets = forces_ops.derive_spring_offsets(np.asarray(p.neighbors))
    new_sh = forces_ops.creep_rest_lengths_shifted(
        p.pos[:, 0], p.pos[:, 1], p.neighbors, offsets, p.rest_len,
        rate, ystr, h
    )
    np.testing.assert_allclose(np.asarray(new_sh), np.asarray(new_rows),
                               rtol=1e-6, atol=1e-9)


def test_creep_permanent_deformation_vs_elastic():
    """Oracle behavior: a stretched-then-released creeping bond settles at a
    LONGER rest separation (permanent deformation); the elastic control
    returns to the original rest length; momentum stays conserved."""
    from spacetime_tpu.state import pack_particles, with_rest_len
    from spacetime_tpu.utils import diagnostics

    rest = DEFAULT_PARAMS.rest_lengths()
    L0 = 1.8 * rest[0]  # stretched start
    pos = np.array([[0.0, 0.0], [L0, 0.0]], np.float32)
    vel = np.zeros_like(pos)
    nbr = np.full((2, 8), -1, np.int32)
    nbr[0, 2] = 1
    nbr[1, 0] = 0
    base = pack_particles(pos, vel, nbr, np.zeros(2, np.int32), capacity=256)
    model = SoftbodyModel(capacity=256)
    damp = jnp.full((256,), 40.0)  # settle oscillations

    def run(table_row):
        mats = materials_ops.ParticleMaterials(
            k_scale=None, damping=damp, break_scale=None,
            creep_rate=jnp.full((256,), table_row[3]),
            yield_strain=jnp.full((256,), table_row[4]),
        ) if table_row[3] > 0 else materials_ops.ParticleMaterials(
            k_scale=None, damping=damp, break_scale=None,
        )
        p = with_rest_len(base, rest) if table_row[3] > 0 else base
        for _ in range(500):
            p, _ = model.step(p, mats)
        return p

    elastic = run((1.0, 40.0, 1.0, 0.0, 0.0))
    plastic = run((1.0, 40.0, 1.0, 50.0, 0.1))

    def sep(p):
        return float(jnp.linalg.norm(p.pos[1] - p.pos[0]))

    # elastic returns near original rest; plastic keeps a longer separation
    assert abs(sep(elastic) - rest[0]) < 0.15 * rest[0]
    assert sep(plastic) > sep(elastic) * 1.1
    # the plastic rest length grew, symmetrically
    assert float(plastic.rest_len[0, 2]) > rest[0] * 1.1
    np.testing.assert_allclose(
        float(plastic.rest_len[0, 2]), float(plastic.rest_len[1, 0]),
        rtol=1e-6,
    )
    # momentum conserved through creeping (forces stayed pairwise opposite)
    tot = diagnostics.totals(plastic)
    assert abs(float(tot.momentum[0])) < 1e-4
    assert abs(float(tot.momentum[1])) < 1e-4


def test_creep_materials_table_plumbing():
    """5-tuple material specs expand to creep planes; 3-tuples stay
    creep-free; engine initializes the rest-length state."""
    p, objects = _two_blob()
    mats = _mats(p, objects, [(1.0, 0.0, 1.0, 5.0, 0.2), (1.0, 0.0, 1.0)])
    assert mats.creep_rate is not None
    arr = np.asarray(mats.creep_rate)
    obj = np.asarray(p.object_index)
    act = np.asarray(p.active)
    assert np.all(arr[act & (obj == 0)] == 5.0)
    assert np.all(arr[act & (obj == 1)] == 0.0)

    mats3 = _mats(p, objects, [(0.5, 0.0, 1.0), (1.0, 0.0, 1.0)])
    assert mats3.creep_rate is None
