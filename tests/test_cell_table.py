"""Dense halo cell-table tests: binning invariants + force parity with the
O(n^2) oracle (this is the production physics path)."""

import jax.numpy as jnp
import numpy as np
import pytest

from spacetime_tpu import scene
from spacetime_tpu.constants import DEFAULT_PARAMS
from spacetime_tpu.ops import forces as forces_ops
from spacetime_tpu.ops import grid as grid_ops

REST = jnp.asarray(DEFAULT_PARAMS.rest_lengths())


def _table_for(pos, active, grid_dim=64, cap=8):
    return grid_ops.build_cell_table(
        jnp.asarray(pos), jnp.asarray(active),
        DEFAULT_PARAMS.grid_resolution, grid_dim, cap,
    )


def test_binning_slots_consistent(rng):
    n = 96
    pos = rng.uniform(0.0, 0.1, (n, 2)).astype(np.float32)
    active = np.ones(n, bool)
    active[-10:] = False
    pos[-10:] = 1e9
    t = _table_for(pos, active)
    idx = np.asarray(t.idx_rows)
    # every active particle appears exactly once in the table
    flat = idx[idx >= 0]
    assert sorted(flat.tolist()) == list(range(86))
    assert int(t.overflow) == 0
    # slot round-trip: idx_rows[slot] == particle
    slot = np.asarray(t.slot)
    for i in range(86):
        assert idx.reshape(-1)[slot[i]] == i


def test_overflow_counts(rng):
    pos = np.full((20, 2), 0.001, np.float32)
    t = _table_for(pos, np.ones(20, bool), cap=4)
    assert int(t.overflow) == 16


def test_cell_forces_match_dense_oracle(rng):
    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(4, 0, (0.0, 0.0), (0.0, 0.0)))
    sb.add(scene.disc_softbody(4, 1, (0.012, 0.007), (0.0, 0.0)))
    particles, _ = sb.build(capacity=256)
    jitter = rng.uniform(-2e-4, 2e-4, particles.pos.shape).astype(np.float32)
    pos = particles.pos + jnp.asarray(jitter) * particles.active[:, None]

    t = grid_ops.build_cell_table(
        pos, particles.active, DEFAULT_PARAMS.grid_resolution, 64, 12
    )
    assert int(t.overflow) == 0
    ncell = grid_ops.neighbor_cells(t, 64)
    idx_nbr = t.idx_rows[ncell]
    f_cells = forces_ops.total_forces_cells(
        pos, particles.neighbors, t, ncell, idx_nbr, REST, DEFAULT_PARAMS
    )
    f_dense = forces_ops.total_forces_dense(
        pos, particles.neighbors, particles.active, REST, DEFAULT_PARAMS
    )
    act = np.asarray(particles.active)
    np.testing.assert_allclose(
        np.asarray(f_cells)[act], np.asarray(f_dense)[act], rtol=1e-4, atol=1e-3
    )
    assert np.abs(np.asarray(f_dense)[act]).max() > 1.0


def test_negative_and_offset_coordinates(rng):
    # scene far from origin with negative coords: floating origin handles it
    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(3, 0, (-5.3, 7.1), (0.0, 0.0)))
    particles, _ = sb.build(capacity=256)
    t = grid_ops.build_cell_table(
        particles.pos, particles.active, DEFAULT_PARAMS.grid_resolution, 64, 8
    )
    assert int(t.overflow) == 0
    ncell = grid_ops.neighbor_cells(t, 64)
    idx_nbr = t.idx_rows[ncell]
    f = forces_ops.total_forces_cells(
        particles.pos, particles.neighbors, t, ncell, idx_nbr, REST, DEFAULT_PARAMS
    )
    act = np.asarray(particles.active)
    np.testing.assert_allclose(np.asarray(f)[act], 0.0, atol=2e-2)


@pytest.mark.parametrize("gap", [0.012, 0.2], ids=["colliding", "apart"])
def test_physics_step_matches_all_pairs_oracle(rng, gap):
    """One full RK4 step on the cell-table path == the same step with every
    particle a collision candidate of every other (the O(n^2) oracle)."""
    import dataclasses

    from spacetime_tpu.ops import rk4

    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(4, 0, (0.0, 0.0), (0.2, 0.0)))
    sb.add(scene.disc_softbody(4, 1, (gap, 0.004), (-0.2, 0.0)))
    particles, _ = sb.build(capacity=256)
    jitter = rng.uniform(-2e-4, 2e-4, particles.pos.shape).astype(np.float32)
    particles = dataclasses.replace(
        particles,
        pos=particles.pos + jnp.asarray(jitter) * particles.active[:, None],
    )
    p_cells, aux = rk4.physics_step(particles, DEFAULT_PARAMS, REST, 64, 12)
    assert int(aux.grid_overflow) == 0
    n = particles.capacity
    idx = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (n, n))
    valid = jnp.broadcast_to(particles.active[None, :], (n, n))
    p_dense, broken = rk4.rk4_step(particles, DEFAULT_PARAMS, REST, idx, valid)
    act = np.asarray(particles.active)
    for a, b in ((p_cells.pos, p_dense.pos), (p_cells.vel, p_dense.vel)):
        np.testing.assert_allclose(np.asarray(a)[act], np.asarray(b)[act],
                                   rtol=1e-4, atol=1e-6)
    assert int(aux.bonds_broken) == int(broken)


@pytest.mark.parametrize("cap,dropped", [(4, 16), (8, 12), (20, 0)])
def test_grid_overflow_count_is_exact(cap, dropped):
    """20 particles in one cell: a cap-slot table drops exactly 20 - cap,
    and the physics step reports the same count in StepAux."""
    from spacetime_tpu.ops import rk4

    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(3, 0, (0.0, 0.0), (0.0, 0.0)))
    particles, _ = sb.build(capacity=32)
    n_act = int(particles.num_active())
    assert n_act >= 20
    pos = np.asarray(particles.pos).copy()
    act = np.zeros(particles.capacity, bool)
    act[:20] = True
    pos[:20] = 0.001 + 1e-5 * np.arange(20)[:, None]
    import dataclasses

    particles = dataclasses.replace(
        particles, pos=jnp.asarray(pos), active=jnp.asarray(act))
    t = grid_ops.build_cell_table(particles.pos, particles.active,
                                  DEFAULT_PARAMS.grid_resolution, 64, cap)
    assert int(t.overflow) == dropped
    _, aux = rk4.physics_step(particles, DEFAULT_PARAMS, REST, 64, cap)
    assert int(aux.grid_overflow) == dropped
