"""Spring + collision force evaluation (the per-particle hot loop).

Port of intent (not code) of `get_forces`
(reference: src/twoplusone/softbody/softbodyrk4.glsl:84-143):

  * Hooke springs to up to 8 bonded neighbors:
        F += -k (|d| - rest) * d/|d|,  d = p_self - p_neighbor
    (reference: softbodyrk4.glsl:119-140)
  * Constant-magnitude pairwise repulsion within `collision_distance` against
    grid candidates, excluding self and bonded neighbors
    (reference: softbodyrk4.glsl:90-114).

Deliberate deviation, documented per SURVEY.md §7: the reference's
neighbor-exclusion check compares *object-relative neighbor ids* against
*spatial-lookup slot indices* (softbodyrk4.glsl:101-108) — an index-space
mismatch that excludes essentially arbitrary particles.  This engine
implements the stated intent ("no colliding with your neighbors!") by
comparing global particle indices.  Self-exclusion follows the reference's
position-equality semantics via the dist > 0 test (softbodyrk4.glsl:99).

Layout: all gathered intermediates are scalar component planes ((N, C), not
(N, C, 2)), so every gather reads and writes contiguous planes (see
ops/worldline.py layout note).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import PhysicsParams

_EPS = 1e-20


def spring_forces(
    pos: jax.Array,  # (N, 2)
    neighbors: jax.Array,  # (N, 8) global indices, -1 = none
    rest_lengths: jax.Array,  # (8,) or (N, 8) per-bond (plastic creep)
    k: float,
) -> jax.Array:
    """Hooke spring force sum over bond slots (softbodyrk4.glsl:119-140)."""
    n = pos.shape[0]
    px, py = pos[:, 0], pos[:, 1]
    valid = neighbors >= 0
    nbr = jnp.clip(neighbors, 0, n - 1)
    dx = px[:, None] - px[nbr]  # (N, 8)
    dy = py[:, None] - py[nbr]
    dist = jnp.sqrt(dx * dx + dy * dy)
    inv = jnp.where(dist > 0, 1.0 / jnp.maximum(dist, _EPS), 0.0)
    rl = rest_lengths[None, :] if rest_lengths.ndim == 1 else rest_lengths
    mag = jnp.where(valid, -k * (dist - rl) * inv, 0.0)
    return jnp.stack([jnp.sum(mag * dx, axis=1), jnp.sum(mag * dy, axis=1)], axis=-1)


def collision_forces(
    pos: jax.Array,  # (N, 2)
    cand_idx: jax.Array,  # (N, C) candidate particle indices
    cand_valid: jax.Array,  # (N, C)
    neighbors: jax.Array,  # (N, 8)
    collision_distance: float,
    repulsion: float,
) -> jax.Array:
    """Constant-magnitude repulsion from grid candidates
    (softbodyrk4.glsl:90-114)."""
    n = pos.shape[0]
    px, py = pos[:, 0], pos[:, 1]
    dx = px[:, None] - px[cand_idx]  # (N, C)
    dy = py[:, None] - py[cand_idx]
    dist = jnp.sqrt(dx * dx + dy * dy)
    is_self = cand_idx == jnp.arange(n, dtype=cand_idx.dtype)[:, None]
    # unrolled over the 8 bond slots: keeps every intermediate at (N, C)
    # instead of materializing an (N, C, 8) comparison tensor
    is_bond = jnp.zeros_like(cand_valid)
    for s in range(neighbors.shape[1]):
        is_bond = is_bond | (cand_idx == neighbors[:, s][:, None])
    hit = cand_valid & ~is_self & ~is_bond & (dist < collision_distance) & (dist > 0)
    mag = jnp.where(hit, repulsion / jnp.maximum(dist, _EPS), 0.0)
    return jnp.stack([jnp.sum(mag * dx, axis=1), jnp.sum(mag * dy, axis=1)], axis=-1)


def total_forces(
    pos: jax.Array,
    neighbors: jax.Array,
    cand_idx: jax.Array,
    cand_valid: jax.Array,
    rest_lengths: jax.Array,
    params: PhysicsParams,
) -> jax.Array:
    """F = springs + collisions (get_forces, softbodyrk4.glsl:84-143)."""
    return spring_forces(pos, neighbors, rest_lengths, params.k) + collision_forces(
        pos,
        cand_idx,
        cand_valid,
        neighbors,
        params.collision_distance,
        params.collision_repulsion_coefficient,
    )


# ---------------------------------------------------------------------------
# Row-gather fast path (dense cell table) — see ops/grid.py CellTable notes.
# Everything below fetches a particle's packed row with ONE row gather, or
# uses static-offset lookups, instead of one scalar gather per component.
# ---------------------------------------------------------------------------


def pack_pos_rows(px: jax.Array, py: jax.Array) -> jax.Array:
    """(N, 8) rows holding [x, y, 0, ...] so neighbor positions come back
    from ONE row gather instead of two scalar gathers."""
    n = px.shape[0]
    rows = jnp.zeros((n, 8), px.dtype)
    return rows.at[:, 0].set(px).at[:, 1].set(py)


def spring_forces_rows(
    px: jax.Array,
    py: jax.Array,
    neighbors: jax.Array,  # (N, 8)
    rest_lengths: jax.Array,  # (8,) or (N, 8) per-bond (plastic creep)
    k: float,
    k_pp=None,  # (N,) optional per-particle stiffness scale
    c_pp=None,  # (N,) optional per-particle damping coefficient
    vx=None,
    vy=None,
) -> tuple[jax.Array, jax.Array]:
    """Hooke springs via row-gathered neighbor positions; returns (fx, fy).

    With materials (ops/materials.py) the SAME single row gather also
    carries the neighbor's k/c/velocity (spare row lanes), adding the
    pairwise-mean stiffness scale and the projected spring-damper force."""
    n = px.shape[0]
    rows = pack_pos_rows(px, py)
    with_mat = k_pp is not None or c_pp is not None
    if with_mat:
        if k_pp is not None:
            rows = rows.at[:, 2].set(k_pp)
        if c_pp is not None:
            rows = rows.at[:, 3].set(c_pp).at[:, 4].set(vx).at[:, 5].set(vy)
    nbr = jnp.clip(neighbors, 0, n - 1)
    g = rows[nbr]  # (N, 8 slots, 8) — one row gather
    dx = px[:, None] - g[..., 0]
    dy = py[:, None] - g[..., 1]
    dist = jnp.sqrt(dx * dx + dy * dy)
    valid = neighbors >= 0
    inv = jnp.where(dist > 0, 1.0 / jnp.maximum(dist, _EPS), 0.0)
    kk = k if k_pp is None else k * 0.5 * (k_pp[:, None] + g[..., 2])
    rl = rest_lengths[None, :] if rest_lengths.ndim == 1 else rest_lengths
    mag = jnp.where(valid, -kk * (dist - rl) * inv, 0.0)
    fx = jnp.sum(mag * dx, axis=1)
    fy = jnp.sum(mag * dy, axis=1)
    if c_pp is not None:
        dvx = vx[:, None] - g[..., 4]
        dvy = vy[:, None] - g[..., 5]
        inv2 = 1.0 / jnp.maximum(dx * dx + dy * dy, _EPS)
        cc = 0.5 * (c_pp[:, None] + g[..., 3])
        dmag = jnp.where(valid, -cc * (dvx * dx + dvy * dy) * inv2, 0.0)
        fx = fx + jnp.sum(dmag * dx, axis=1)
        fy = fy + jnp.sum(dmag * dy, axis=1)
    return fx, fy


def derive_spring_offsets(neighbors, max_offsets: int = 8):
    """Distinct index offsets (nbr[i, s] - i) per bond slot, from the initial
    neighbor table (host-side, numpy).

    With a lattice-padded scene layout (scene.mask_to_softbody
    lattice_pad=True) every slot has one constant offset per object
    ({±1, ±W, ±W±1} for bbox width W), so bonded positions can be read by
    static shifted slices instead of row gathers.  Returns
    a tuple of 8 offset tuples, or None when a slot has more than
    `max_offsets` distinct values (irregular graph -> use the gather path).
    Bond BREAKING only writes -1, so offsets derived at setup stay valid.
    """
    import numpy as np

    nbr = np.asarray(neighbors)
    n = nbr.shape[0]
    idx = np.arange(n, dtype=np.int64)
    out = []
    for s in range(nbr.shape[1]):
        col = nbr[:, s].astype(np.int64)
        valid = col >= 0
        d = np.unique(col[valid] - idx[valid])
        if d.size > max_offsets:
            return None
        out.append(tuple(int(x) for x in d))
    return tuple(out)


def spring_forces_shifted(px, py, neighbors, offsets, rest_lengths, k,
                          k_pp=None):
    """Hooke springs with bonded positions read by static shifted slices —
    zero gathers.  For each (slot s, offset d), the mask nbr[:, s] == i + d
    selects exactly the particles whose slot-s bond is the +d shift; rolled
    reads are only consumed under that mask, so wraparound lanes and
    inactive 1e9 slots never contribute.  Equivalent to spring_forces_rows
    (same formula, same per-slot rest lengths).

    `k_pp` (N,) optionally scales stiffness per particle (ops/materials.py);
    the pair uses the endpoint mean so forces stay equal-and-opposite."""
    n = px.shape[0]
    iota = jnp.arange(n, dtype=neighbors.dtype)
    fx = jnp.zeros_like(px)
    fy = jnp.zeros_like(py)
    for s, ds in enumerate(offsets):
        col = neighbors[:, s]
        bonded = col >= 0  # the -1 sentinel would otherwise match iota + d
        # at i == -1 - d, phantom-bonding low indices to wrapped lanes
        for d in ds:
            sel = bonded & (col == iota + d)
            dx = px - jnp.roll(px, -d)
            dy = py - jnp.roll(py, -d)
            dist = jnp.sqrt(dx * dx + dy * dy)
            inv = jnp.where(dist > 0, 1.0 / jnp.maximum(dist, _EPS), 0.0)
            kk = k if k_pp is None else k * 0.5 * (k_pp + jnp.roll(k_pp, -d))
            rl = (rest_lengths[s] if rest_lengths.ndim == 1
                  else rest_lengths[:, s])
            mag = jnp.where(sel, -kk * (dist - rl) * inv, 0.0)
            fx = fx + mag * dx
            fy = fy + mag * dy
    return fx, fy


def bond_damping_shifted(px, py, vx, vy, neighbors, offsets, c_pp):
    """Spring-damper force along bonds, shifted-slice reads:
    F_i = -c_ij ((v_i - v_j)·d̂) d̂ with c_ij = mean(c_i, c_j) — symmetric,
    so total momentum is conserved.  Velocities are the step's ORIGINAL
    velocities (the integrator evaluates every stage against them, see
    ops/rk4.py module docstring)."""
    n = px.shape[0]
    iota = jnp.arange(n, dtype=neighbors.dtype)
    fx = jnp.zeros_like(px)
    fy = jnp.zeros_like(py)
    for s, ds in enumerate(offsets):
        col = neighbors[:, s]
        bonded = col >= 0  # exclude the -1 sentinel (see spring_forces_shifted)
        for d in ds:
            sel = bonded & (col == iota + d)
            dx = px - jnp.roll(px, -d)
            dy = py - jnp.roll(py, -d)
            dvx = vx - jnp.roll(vx, -d)
            dvy = vy - jnp.roll(vy, -d)
            inv2 = 1.0 / jnp.maximum(dx * dx + dy * dy, _EPS)
            cc = 0.5 * (c_pp + jnp.roll(c_pp, -d))
            mag = jnp.where(sel, -cc * (dvx * dx + dvy * dy) * inv2, 0.0)
            fx = fx + mag * dx
            fy = fy + mag * dy
    return fx, fy


def bonded_repulsion_shifted(px, py, neighbors, offsets, collision_distance,
                             repulsion):
    """Repulsion contributed by BONDED neighbors, via shifted slices — the
    exact formula the Pallas collision kernel uses per hit (rsqrt of dist2,
    constant magnitude).  Subtracted from an exclude_bonds=False kernel run
    to reproduce the reference's bonded-pair exclusion
    (softbodyrk4.glsl:101-108) without the kernel's 8-compare inner loop."""
    n = px.shape[0]
    iota = jnp.arange(n, dtype=neighbors.dtype)
    cd2 = collision_distance * collision_distance
    fx = jnp.zeros_like(px)
    fy = jnp.zeros_like(py)
    for s, ds in enumerate(offsets):
        col = neighbors[:, s]
        bonded = col >= 0  # exclude the -1 sentinel (see spring_forces_shifted)
        for d in ds:
            sel = bonded & (col == iota + d)
            dx = px - jnp.roll(px, -d)
            dy = py - jnp.roll(py, -d)
            dist2 = dx * dx + dy * dy
            hit = sel & (dist2 < cd2) & (dist2 > 0.0)
            inv = jax.lax.rsqrt(jnp.maximum(dist2, 1e-20))
            mag = jnp.where(hit, repulsion * inv, 0.0)
            fx = fx + mag * dx
            fy = fy + mag * dy
    return fx, fy


def collision_forces_cells(
    px: jax.Array,
    py: jax.Array,
    xy_rows: jax.Array,  # (n_cells + 1, 2*cap) per-stage position planes
    ncell: jax.Array,  # (N, 9) neighbor cell ids (grid.neighbor_cells)
    idx_nbr: jax.Array,  # (N, 9, cap) candidate particle ids (-1 empty)
    neighbors: jax.Array,  # (N, 8) bond table
    collision_distance: float,
    repulsion: float,
) -> tuple[jax.Array, jax.Array]:
    """Constant-magnitude repulsion over the 9-cell neighborhood
    (softbodyrk4.glsl:90-114) with zero scalar gathers: candidate positions
    arrive via one row gather of the per-stage position planes."""
    n = px.shape[0]
    cap = xy_rows.shape[1] // 2
    xy = xy_rows[ncell]  # (N, 9, 2*cap) — one row gather per stage
    candx = xy[..., :cap]
    candy = xy[..., cap:]
    ddx = px[:, None, None] - candx
    ddy = py[:, None, None] - candy
    dist = jnp.sqrt(ddx * ddx + ddy * ddy)
    valid = idx_nbr >= 0
    is_self = idx_nbr == jnp.arange(n, dtype=jnp.int32)[:, None, None]
    is_bond = jnp.zeros_like(valid)
    for s in range(neighbors.shape[1]):
        is_bond = is_bond | (idx_nbr == neighbors[:, s][:, None, None])
    hit = valid & ~is_self & ~is_bond & (dist < collision_distance) & (dist > 0)
    mag = jnp.where(hit, repulsion / jnp.maximum(dist, _EPS), 0.0)
    return (
        jnp.sum(mag * ddx, axis=(1, 2)),
        jnp.sum(mag * ddy, axis=(1, 2)),
    )


def total_forces_cells(
    pos: jax.Array,
    neighbors: jax.Array,
    table,
    ncell: jax.Array,
    idx_nbr: jax.Array,
    rest_lengths: jax.Array,
    params: PhysicsParams,
    materials=None,  # ops.materials.ParticleMaterials
    vel0=None,  # (N, 2) step-original velocities (damping only)
) -> jax.Array:
    """get_forces (softbodyrk4.glsl:84-143) on the dense cell table."""
    from . import grid as grid_ops

    px, py = pos[:, 0], pos[:, 1]
    xy_rows = grid_ops.scatter_plane_xy(table, px, py, 1.0e9)  # (n_cells+1, 2cap)
    k_pp = c_pp = vx = vy = None
    if materials is not None:
        k_pp = materials.k_scale
        if vel0 is not None:
            c_pp, vx, vy = materials.damping, vel0[:, 0], vel0[:, 1]
    sfx, sfy = spring_forces_rows(px, py, neighbors, rest_lengths, params.k,
                                  k_pp=k_pp, c_pp=c_pp, vx=vx, vy=vy)
    cfx, cfy = collision_forces_cells(
        px, py, xy_rows, ncell, idx_nbr, neighbors,
        params.collision_distance, params.collision_repulsion_coefficient,
    )
    return jnp.stack([sfx + cfx, sfy + cfy], axis=-1)


def total_forces_dense(
    pos: jax.Array,
    neighbors: jax.Array,
    active: jax.Array,
    rest_lengths: jax.Array,
    params: PhysicsParams,
) -> jax.Array:
    """O(n^2) oracle: identical physics with all-pairs collision candidates.

    The test reference for the grid path (SURVEY.md §4); only usable at
    testimg3 scale.
    """
    n = pos.shape[0]
    idx = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (n, n))
    valid = jnp.broadcast_to(active[None, :], (n, n))
    return total_forces(pos, neighbors, idx, valid, rest_lengths, params)


def creep_rest_lengths_shifted(px, py, neighbors, offsets, rest_len,
                               creep_rate, yield_strain, h):
    """Plastic creep: per-bond rest lengths grow toward the current length
    when stretched past the yield strain (permanent deformation).

    R' = R + c_pair * h * max(0, L - R * (1 + y_pair))

    with c_pair = min(c_i, c_j) and y_pair = max(y_i, y_j) — both symmetric
    pair reductions, so the two reciprocal slots of a bond update to the
    same value and bond forces stay equal-and-opposite.  The reference has
    one rigid global material (softbodyrk4.glsl:24-33); this extends the
    round-2 material table along ROADMAP's plastic-creep axis.  Reads use
    the same shifted-slice masking as spring_forces_shifted."""
    n = px.shape[0]
    iota = jnp.arange(n, dtype=neighbors.dtype)
    cols = []
    for s, ds in enumerate(offsets):
        col = neighbors[:, s]
        bonded = col >= 0
        r_s = rest_len[:, s]
        new_s = r_s
        for d in ds:
            sel = bonded & (col == iota + d)
            dx = px - jnp.roll(px, -d)
            dy = py - jnp.roll(py, -d)
            dist = jnp.sqrt(dx * dx + dy * dy)
            c_pair = jnp.minimum(creep_rate, jnp.roll(creep_rate, -d))
            if yield_strain is None:
                y_pair = 0.0
            else:
                y_pair = jnp.maximum(yield_strain, jnp.roll(yield_strain, -d))
            excess = jnp.maximum(0.0, dist - r_s * (1.0 + y_pair))
            new_s = jnp.where(sel, r_s + c_pair * h * excess, new_s)
        cols.append(new_s)
    return jnp.stack(cols, axis=1)


def creep_rest_lengths_rows(pos, neighbors, rest_len, creep_rate,
                            yield_strain, h):
    """creep_rest_lengths_shifted via row gathers (non-lattice scenes)."""
    n = pos.shape[0]
    valid = neighbors >= 0
    clipped = jnp.clip(neighbors, 0, n - 1)
    nbr_pos = pos[clipped]
    dist = jnp.linalg.norm(pos[:, None, :] - nbr_pos, axis=-1)
    c_pair = jnp.minimum(creep_rate[:, None], creep_rate[clipped])
    if yield_strain is None:
        y_pair = 0.0
    else:
        y_pair = jnp.maximum(yield_strain[:, None], yield_strain[clipped])
    excess = jnp.maximum(0.0, dist - rest_len * (1.0 + y_pair))
    return jnp.where(valid, rest_len + c_pair * h * excess, rest_len)
