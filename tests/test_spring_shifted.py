"""Shifted-slice spring/bond path vs the row-gather path.

With a lattice-padded scene layout every bond slot's neighbor index is
i + d for a handful of static offsets d, so springs and bond breaking can
read bonded positions via jnp.roll shifts (ops/forces.spring_forces_shifted,
ops/rk4.break_bonds_shifted).  These must match the gather implementations
on the same state."""

import numpy as np
import jax.numpy as jnp

from spacetime_tpu import scene
from spacetime_tpu.models.softbody import SoftbodyModel
from spacetime_tpu.ops import forces as forces_ops
from spacetime_tpu.ops import rk4 as rk4_ops


def _padded_scene():
    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(5, 0, (0.0, 0.0), (0.05, 0.0), lattice_pad=True))
    sb.add(scene.disc_softbody(4, 1, (0.06, 0.01), (-0.05, 0.0), lattice_pad=True))
    return sb.build(capacity=512)


def test_derive_offsets_padded_disc():
    p, _ = _padded_scene()
    offsets = forces_ops.derive_spring_offsets(np.asarray(p.neighbors))
    assert offsets is not None
    # slot 0 is "left": offset -1 for every object
    assert offsets[0] == (-1,)
    # diagonal slots carry one offset per object (bbox widths 11 and 9)
    assert all(len(ds) <= 2 for ds in offsets)


def test_derive_offsets_unpadded_disc_falls_back():
    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(12, 0, (0.0, 0.0), (0.0, 0.0)))
    p, _ = sb.build(capacity=512)
    assert forces_ops.derive_spring_offsets(np.asarray(p.neighbors)) is None


def test_spring_forces_shifted_matches_rows():
    p, _ = _padded_scene()
    offsets = forces_ops.derive_spring_offsets(np.asarray(p.neighbors))
    rest = jnp.asarray(SoftbodyModel(capacity=p.capacity).params.rest_lengths())
    # perturb positions so forces are nonzero
    rng = np.random.default_rng(0)
    pos = np.asarray(p.pos) + rng.normal(0, 3e-4, np.asarray(p.pos).shape).astype(np.float32)
    px, py = jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1])
    fx_r, fy_r = forces_ops.spring_forces_rows(px, py, p.neighbors, rest, 15000.0)
    fx_s, fy_s = forces_ops.spring_forces_shifted(
        px, py, p.neighbors, offsets, rest, 15000.0
    )
    np.testing.assert_allclose(np.asarray(fx_s), np.asarray(fx_r), atol=2e-2)
    np.testing.assert_allclose(np.asarray(fy_s), np.asarray(fy_r), atol=2e-2)


def test_break_bonds_shifted_matches_gather():
    p, _ = _padded_scene()
    offsets = forces_ops.derive_spring_offsets(np.asarray(p.neighbors))
    # stretch one bonded pair past the threshold
    pos = np.asarray(p.pos).copy()
    nbr = np.asarray(p.neighbors)
    act = np.asarray(p.active)
    i = int(np.nonzero(act & (nbr[:, 2] >= 0))[0][0])  # has a "right" bond
    j = int(nbr[i, 2])
    pos[j] = pos[i] + np.float32([0.02, 0.0])  # > threshold 0.01
    pos_j = jnp.asarray(pos)
    n_g, c_g = rk4_ops.break_bonds(pos_j, p.neighbors, 0.01)
    n_s, c_s = rk4_ops.break_bonds_shifted(pos_j, p.neighbors, offsets, 0.01)
    assert int(c_s) == int(c_g) > 0
    np.testing.assert_array_equal(np.asarray(n_s), np.asarray(n_g))


def test_full_step_padded_matches_unpadded_physics():
    """The padded layout must not change the physics: run both layouts of
    the same two-disc scene and compare active-particle trajectories."""
    def build(pad):
        sb = scene.SceneBuilder()
        sb.add(scene.disc_softbody(5, 0, (0.0, 0.0), (0.05, 0.0), lattice_pad=pad))
        sb.add(scene.disc_softbody(5, 1, (0.045, 0.002), (-0.05, 0.0), lattice_pad=pad))
        p, _ = sb.build(capacity=512)
        offsets = forces_ops.derive_spring_offsets(np.asarray(p.neighbors)) if pad else None
        model = SoftbodyModel(capacity=p.capacity, spring_offsets=offsets)
        return p, model

    p_u, m_u = build(False)
    p_p, m_p = build(True)
    for _ in range(30):
        p_u, _ = m_u.step(p_u)
        p_p, _ = m_p.step(p_p)
    act_u = np.asarray(p_u.active)
    act_p = np.asarray(p_p.active)
    assert act_u.sum() == act_p.sum()
    np.testing.assert_allclose(
        np.asarray(p_p.pos)[act_p], np.asarray(p_u.pos)[act_u], atol=1e-5
    )
