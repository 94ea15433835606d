"""Hashed uniform collision grid, rebuilt every step.

The reference builds a Sebastian-Lague-style spatial hash on the GPU with
three passes — FILL_LOOKUP writes (cell_key, particle_idx) pairs, a
host-orchestrated bitonic merge sort over log^2(n) dispatches sorts them, and
UPDATE_START_INDICES marks the first occurrence of each key
(reference: src/twoplusone/softbody/collision_grid_update.glsl:49-98, host
sort ladder src/twoplusone/softbody/mod.rs:707-767).

Redesign: one `jax.lax.sort_key_val` (XLA's fused on-device sort
replaces the 55-dispatch bitonic ladder), a scatter-min for start indices, a
scatter-add for cell counts, and a *fixed-capacity* candidate gather so the
downstream force kernel is fully regular (no data-dependent loops — the
do/while scan at softbodyrk4.glsl:96-113 becomes a masked (9*K,) gather).

A further semantic win: candidate *indices* are computed once per step from
the start-of-step positions, exactly matching the reference, which rebuilds
the grid after the previous step and reuses it for all five RK4 stages
(reference: src/twoplusone/softbody/mod.rs:557-596).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..constants import PhysicsParams

# 9-cell neighborhood offsets, i = 0..8, i=4 is (0,0)
# (reference: softbodyrk4.glsl:93-94).
_NEIGHBOR_CELLS = [((i % 3) - 1, (i // 3) - 1) for i in range(9)]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CollisionGrid:
    """Sorted spatial lookup (the reference's spatial_lookup/start_indices
    pair, collision_grid_update.glsl:20-30) plus per-key counts."""

    sorted_idx: jax.Array  # (N,) i32 — particle indices sorted by cell key
    starts: jax.Array  # (table_size + 1,) i32 — first slot per key (N if empty)
    counts: jax.Array  # (table_size + 1,) i32 — particles per key
    keys: jax.Array  # (N,) i32 — cell key per particle (unsorted)

    @property
    def table_size(self) -> int:
        return self.starts.shape[0] - 1


def hash_cell_xy(cx: jax.Array, cy: jax.Array, table_mask: int) -> jax.Array:
    """Scalar-component cell hash (no (..., 2) arrays are materialized)."""
    x = cx.astype(jnp.uint32)
    y = cy.astype(jnp.uint32)
    h = x * jnp.uint32(0x9E3779B1) ^ (y * jnp.uint32(0x85EBCA77))
    h = h ^ (h >> jnp.uint32(15))
    return (h & jnp.uint32(table_mask)).astype(jnp.int32)


def hash_cell(cell: jax.Array, table_mask: int) -> jax.Array:
    """Hash integer cell coords (..., 2) to a table key.

    Replaces the reference's `abs(x)*15823 + abs(y)*9737333 % n` hash
    (reference: src/twoplusone/common.glsl:35-39) — whose abs() folds
    negative coordinates onto positive ones — with a standard two-prime
    xor mix that treats signed coordinates distinctly.
    """
    return hash_cell_xy(cell[..., 0], cell[..., 1], table_mask)


def cell_of(pos: jax.Array, grid_resolution: float) -> jax.Array:
    """Integer cell coordinates (reference: softbodyrk4.glsl:91)."""
    return jnp.floor(pos / grid_resolution).astype(jnp.int32)


@partial(jax.jit, static_argnames=("table_size",))
def build_grid(pos: jax.Array, active: jax.Array, grid_resolution, table_size: int) -> CollisionGrid:
    """Bin particles into the hashed grid.  `table_size` must be a power of 2.

    Inactive (padding) particles get the out-of-range key == table_size so
    they sort to the end and are never returned by queries.
    """
    n = pos.shape[0]
    assert table_size & (table_size - 1) == 0, "table_size must be a power of two"
    key = hash_cell(cell_of(pos, grid_resolution), table_size - 1)
    key = jnp.where(active, key, table_size)
    sorted_key, sorted_idx = jax.lax.sort_key_val(key, jnp.arange(n, dtype=jnp.int32))
    starts = jnp.full((table_size + 1,), n, jnp.int32)
    starts = starts.at[sorted_key].min(jnp.arange(n, dtype=jnp.int32))
    counts = jnp.zeros((table_size + 1,), jnp.int32).at[key].add(1)
    return CollisionGrid(sorted_idx=sorted_idx, starts=starts, counts=counts, keys=key)


def collision_candidates(
    grid: CollisionGrid,
    pos: jax.Array,
    grid_resolution,
    cell_capacity: int,
) -> tuple[jax.Array, jax.Array]:
    """For each particle, gather candidate indices from its 9-cell
    neighborhood (reference: softbodyrk4.glsl:90-114), capped at
    `cell_capacity` per hash key.

    Returns (cand_idx (N, 9*K) i32, cand_valid (N, 9*K) bool).  Capping is the
    price of regularity; `grid_overflow` reports how many were dropped so
    callers/tests can size K.
    """
    n = pos.shape[0]
    k = cell_capacity
    table_mask = grid.table_size - 1
    cell = cell_of(pos, grid_resolution)
    offs = jnp.array(_NEIGHBOR_CELLS, jnp.int32)  # (9, 2)
    nbr_keys = hash_cell(cell[:, None, :] + offs[None, :, :], table_mask)  # (N, 9)
    # Dedupe hash keys among the 9 cells: when two distinct neighbor cells
    # collide to one key, scanning that bucket twice would double-count every
    # candidate in it.  (The reference HAS this double-count — its do/while
    # rescans the shared bucket per colliding cell, softbodyrk4.glsl:93-114 —
    # we deliberately fix it; the dense oracle defines correct physics.)
    first_occurrence = jnp.ones_like(nbr_keys, bool)
    for a in range(1, 9):
        dup = jnp.zeros(nbr_keys.shape[:1], bool)
        for b in range(a):
            dup = dup | (nbr_keys[:, a] == nbr_keys[:, b])
        first_occurrence = first_occurrence.at[:, a].set(~dup)
    s = grid.starts[nbr_keys]  # (N, 9)
    c = jnp.where(first_occurrence, grid.counts[nbr_keys], 0)  # (N, 9)
    j = jnp.arange(k, dtype=jnp.int32)
    slot = s[:, :, None] + j[None, None, :]  # (N, 9, K)
    valid = j[None, None, :] < jnp.minimum(c[:, :, None], k)
    cand = grid.sorted_idx[jnp.clip(slot, 0, n - 1)]
    return cand.reshape(n, 9 * k), valid.reshape(n, 9 * k)


def grid_overflow(grid: CollisionGrid, cell_capacity: int) -> jax.Array:
    """Total candidates dropped by the capacity cap (diagnostic)."""
    over = jnp.maximum(grid.counts[:-1] - cell_capacity, 0)
    return jnp.sum(over)


# ---------------------------------------------------------------------------
# Dense halo cell table (the fast physics path)
# ---------------------------------------------------------------------------
#
# The hash-grid candidate gather above costs (N, 9*K) SCALAR gathers per
# force evaluation; this dense table
# replaces it with 9 static-offset ROW gathers: particles are binned into a
# dense (cells+halo, cap) slot grid whose per-cell rows hold positions, so a
# particle's 9-cell neighborhood is 9 row lookups.  The one-cell halo makes
# neighbor cell ids always in-range (no border branches), like a ghost-cell
# stencil.  The binning (slots) is built once per step from start-of-step
# positions — exactly the reference's grid reuse across RK4 stages
# (softbody/mod.rs:557-596) — while position planes are re-scattered per
# stage so forces see intermediate positions (softbodyrk4.glsl state reads).


class CellTable(NamedTuple):
    """Per-step binning of particles into a dense halo grid."""

    slot: jax.Array  # (N,) i32 — flat slot (cell*cap + rank); dump slot if invalid
    cell: jax.Array  # (N,) i32 — flat halo cell id; n_cells for inactive
    idx_rows: jax.Array  # (n_cells + 1, cap) i32 — particle id per slot, -1 empty
    overflow: jax.Array  # () i32 — particles dropped by the per-cell cap
    origin: jax.Array  # (2,) f32 — grid origin (traced)

    @property
    def cap(self) -> int:
        return self.idx_rows.shape[1]

    @property
    def n_cells(self) -> int:
        return self.idx_rows.shape[0] - 1


def cell_ids(pos: jax.Array, active: jax.Array, grid_resolution, grid_dim: int):
    """Flat halo cell id per particle + floating grid origin (no table).

    The grid origin floats with the scene (min active position minus one
    cell), so the static `grid_dim` only caps the live EXTENT
    (grid_dim * resolution lightseconds); out-of-extent particles clamp into
    border cells, which keeps near-pairs co-located (correct, just denser).
    Inactive particles map to cell id n_cells (past the halo grid)."""
    side = grid_dim + 2
    n_cells = side * side
    px, py = pos[:, 0], pos[:, 1]
    big = jnp.float32(3.0e38)
    ox = jnp.min(jnp.where(active, px, big)) - 2.0 * grid_resolution
    oy = jnp.min(jnp.where(active, py, big)) - 2.0 * grid_resolution
    cx = jnp.clip(jnp.floor((px - ox) / grid_resolution).astype(jnp.int32), 0, grid_dim - 1) + 1
    cy = jnp.clip(jnp.floor((py - oy) / grid_resolution).astype(jnp.int32), 0, grid_dim - 1) + 1
    cell = jnp.where(active, cy * side + cx, n_cells)
    return cell, jnp.stack([ox, oy])


def build_cell_table(
    pos: jax.Array,
    active: jax.Array,
    grid_resolution,
    grid_dim: int,
    cell_capacity: int,
) -> CellTable:
    """Bin particles into a (grid_dim + 2 halo)^2 dense cell grid
    (see cell_ids for the floating-origin semantics)."""
    n = pos.shape[0]
    cap = cell_capacity
    side = grid_dim + 2
    n_cells = side * side
    cell, origin = cell_ids(pos, active, grid_resolution, grid_dim)

    skey, sidx = jax.lax.sort_key_val(cell, jnp.arange(n, dtype=jnp.int32))
    starts = jnp.full((n_cells + 2,), n, jnp.int32)
    starts = starts.at[skey].min(jnp.arange(n, dtype=jnp.int32))
    rank_sorted = jnp.arange(n, dtype=jnp.int32) - starts[skey]
    rank = jnp.zeros((n,), jnp.int32).at[sidx].set(rank_sorted)

    fits = active & (rank < cap)
    dump = n_cells * cap  # first slot of the (empty) dump row
    slot = jnp.where(fits, cell * cap + rank, dump)
    idx_rows = jnp.full(((n_cells + 1) * cap,), -1, jnp.int32)
    idx_rows = idx_rows.at[slot].set(jnp.arange(n, dtype=jnp.int32))
    # the dump slot may hold one arbitrary id; erase it
    idx_rows = idx_rows.at[dump].set(-1)
    overflow = jnp.sum((active & (rank >= cap)).astype(jnp.int32))
    return CellTable(
        slot=slot,
        cell=cell,
        idx_rows=idx_rows.reshape(n_cells + 1, cap),
        overflow=overflow,
        origin=origin,
    )


def scatter_plane(table: CellTable, values: jax.Array, fill: float) -> jax.Array:
    """Scatter per-particle scalar values into the table's slot layout,
    returning (n_cells + 1, cap) rows.  Called per RK4 stage for positions."""
    cap = table.cap
    plane = jnp.full(((table.n_cells + 1) * cap,), fill, values.dtype)
    plane = plane.at[table.slot].set(values)
    plane = plane.at[table.n_cells * cap].set(fill)  # clear dump slot
    return plane.reshape(table.n_cells + 1, cap)


def scatter_plane_xy(table: CellTable, px: jax.Array, py: jax.Array, fill: float):
    """Scatter x into columns [0, cap) and y into [cap, 2cap) of one
    (n_cells + 1, 2cap) row buffer — a single allocation per force stage
    instead of two planes + a concatenate."""
    cap = table.cap
    width = 2 * cap
    rows = table.n_cells + 1
    cell = table.slot // cap
    rank = table.slot % cap
    sx = cell * width + rank
    plane = jnp.full((rows * width,), fill, px.dtype)
    plane = plane.at[sx].set(px)
    plane = plane.at[sx + cap].set(py)
    # clear anything parked in the dump row
    plane = jax.lax.dynamic_update_slice(
        plane, jnp.full((width,), fill, px.dtype), (table.n_cells * width,)
    )
    return plane.reshape(rows, width)


def neighbor_cells(table: CellTable, grid_dim: int) -> jax.Array:
    """(N, 9) flat cell ids of each particle's 3x3 neighborhood (halo makes
    all offsets in-range); inactive particles point at the empty dump row."""
    side = grid_dim + 2
    offs = jnp.array(
        [dy * side + dx for dy in (-1, 0, 1) for dx in (-1, 0, 1)], jnp.int32
    )
    ncell = table.cell[:, None] + offs[None, :]
    # inactive (cell == n_cells) stays clamped at the dump row
    return jnp.clip(ncell, 0, table.n_cells)


def default_table_size(capacity: int) -> int:
    """2x next-pow2(N): halves hash-collision rate vs the reference's
    table_size == num_particles (common.glsl:38)."""
    size = 1
    while size < capacity:
        size *= 2
    return size * 2
