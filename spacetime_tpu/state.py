"""Simulation state pytrees (structure-of-arrays).

The reference keeps an array-of-structs particle buffer (64-byte `Particle`,
reference: src/twoplusone/common.glsl:1-13 and src/twoplusone/softbody/mod.rs:64-90)
plus a per-object uniform buffer holding each object's offset into the
particle buffer (`Object`, reference: src/twoplusone/common.glsl:15-22).

Layout differences (deliberate):
  * Structure-of-arrays — `pos (N,2)`, `vel (N,2)`, ... — so every field is
    a dense array instead of strided 64-byte records.
  * Neighbor indices are stored as *global* particle indices with -1
    sentinels, folding the reference's `object.offset` indirection
    (reference: softbodyrk4.glsl:123, common.glsl:17-18) into the table at
    import time.  Slots 0-3 are the immediate (left/up/right/down) bonds,
    slots 4-7 the diagonal (tl/tr/bl/br) bonds, matching the reference's slot
    order so symmetric bond breaking can use the same slot-pairing rule
    (reference: softbodyrk4.glsl:241,249).
  * `N` is a static (padded) capacity; `active` masks real particles, so every
    jitted shape is fixed regardless of scene contents.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .constants import NUM_NEIGHBORS


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Particles:
    """SoA particle state. All arrays have leading dim N (padded capacity)."""

    pos: jax.Array  # (N, 2) f32 — ground-frame position, lightseconds
    vel: jax.Array  # (N, 2) f32 — ground-frame velocity, fraction of c
    rest_mass: jax.Array  # (N,) f32
    neighbors: jax.Array  # (N, 8) i32 — global indices, -1 = no bond
    object_index: jax.Array  # (N,) i32
    particle_id: jax.Array  # (N,) i32 — globally unique (reference: mod.rs:157)
    active: jax.Array  # (N,) bool — False for padding slots
    # (N, 8) f32 per-BOND rest lengths — plastic-creep state (ops/materials
    # creep_rate): bonds stretched past their yield strain permanently
    # lengthen.  None = rigid rest lengths (the reference's global constants,
    # twoplusone/mod.rs:16-19); populated by with_rest_len() when a creeping
    # material is configured.  Updates are symmetric (both endpoints compute
    # the same new value from the same pair quantities), so the reciprocal
    # slots never diverge.
    rest_len: Optional[jax.Array] = None

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    def num_active(self) -> jax.Array:
        return jnp.sum(self.active.astype(jnp.int32))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Objects:
    """Per-object table (the reference's `Object` UBO, common.glsl:15-22).

    `offset` is retained for API parity even though neighbor indices are
    already global in this engine; `material_index` drives shading.
    """

    offset: jax.Array  # (MAX_OBJECTS,) i32
    material_index: jax.Array  # (MAX_OBJECTS,) i32
    base_color: jax.Array  # (MAX_OBJECTS, 3) f32 — renderer albedo


def make_objects(max_objects: int, specs=None) -> Objects:
    """Build an Objects table from a list of (offset, material_index, rgb)."""
    offset = np.zeros((max_objects,), np.int32)
    material = np.zeros((max_objects,), np.int32)
    # Default palette mirrors the debug point renderer: object 0 blue,
    # others red (reference: src/twoplusone/softbody/points_norel.glsl:44-50).
    color = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (max_objects, 1))
    if max_objects > 0:
        color[0] = (0.0, 0.0, 1.0)
    for i, spec in enumerate(specs or []):
        offset[i] = spec.get("offset", 0)
        material[i] = spec.get("material_index", 0)
        if "base_color" in spec:
            color[i] = spec["base_color"]
    return Objects(
        offset=jnp.asarray(offset),
        material_index=jnp.asarray(material),
        base_color=jnp.asarray(color),
    )


def pack_particles(
    pos: np.ndarray,
    vel: np.ndarray,
    neighbors: np.ndarray,
    object_index: np.ndarray,
    rest_mass: Optional[np.ndarray] = None,
    particle_id: Optional[np.ndarray] = None,
    capacity: Optional[int] = None,
    pad_multiple: int = 256,
    active: Optional[np.ndarray] = None,
) -> Particles:
    """Pad host-side arrays to a static capacity and move them to device.

    The analog of `SoftbodyState::push` staging upload
    (reference: src/twoplusone/softbody/mod.rs:457-539), minus the staging
    buffer — jax.device_put handles the host->HBM copy.
    """
    n = pos.shape[0]
    cap = capacity if capacity is not None else _round_up(max(n, pad_multiple), pad_multiple)
    if n > cap:
        raise ValueError(f"{n} particles exceed capacity {cap}")
    if rest_mass is None:
        rest_mass = np.ones((n,), np.float32)
    if particle_id is None:
        particle_id = np.arange(n, dtype=np.int32)
    if active is None:
        active = np.ones((n,), bool)  # interior inactive slots: lattice_pad

    def pad(a, fill):
        out = np.full((cap,) + a.shape[1:], fill, dtype=a.dtype)
        out[:n] = a
        return out

    # Padding particles are parked far away so they never land in an occupied
    # collision-grid cell, and carry no bonds.
    far = 1.0e9
    return Particles(
        pos=jnp.asarray(pad(pos.astype(np.float32), far)),
        vel=jnp.asarray(pad(vel.astype(np.float32), 0.0)),
        rest_mass=jnp.asarray(pad(rest_mass.astype(np.float32), 1.0)),
        neighbors=jnp.asarray(pad(neighbors.astype(np.int32), -1)),
        object_index=jnp.asarray(pad(object_index.astype(np.int32), 0)),
        particle_id=jnp.asarray(pad(particle_id.astype(np.int32), -1)),
        active=jnp.asarray(pad(np.asarray(active, bool), False)),
    )


def with_rest_len(particles: Particles, slot_rest_lengths) -> Particles:
    """Initialize the plastic-creep rest-length state: every bond starts at
    its slot's rigid rest length (constants.PhysicsParams.rest_lengths)."""
    n = particles.capacity
    rl = jnp.broadcast_to(
        jnp.asarray(slot_rest_lengths, jnp.float32)[None, :], (n, NUM_NEIGHBORS)
    )
    return dataclasses.replace(particles, rest_len=rl)


def concat_particle_arrays(parts):
    """Concatenate host-side particle dicts (from scene import), rebasing
    neighbor indices to global — the analog of `SoftbodyState::add_particles`
    (reference: src/twoplusone/softbody/mod.rs:770-778).

    Returns (pos, vel, neighbors, object_index, particle_id, active)."""
    pos, vel, nbr, obj, ids, act = [], [], [], [], [], []
    base = 0
    next_id = 0
    for p in parts:
        n = p["pos"].shape[0]
        pos.append(p["pos"])
        vel.append(p["vel"])
        nb = p["neighbors"].copy()
        nb[nb >= 0] += base
        nbr.append(nb)
        obj.append(p["object_index"])
        ids.append(np.arange(next_id, next_id + n, dtype=np.int32))
        act.append(np.asarray(p.get("active", np.ones((n,), bool)), bool))
        base += n
        next_id += n
    if not pos:
        z2 = np.zeros((0, 2), np.float32)
        return (
            z2,
            z2,
            np.zeros((0, NUM_NEIGHBORS), np.int32),
            np.zeros((0,), np.int32),
            np.zeros((0,), np.int32),
            np.zeros((0,), bool),
        )
    return (
        np.concatenate(pos),
        np.concatenate(vel),
        np.concatenate(nbr),
        np.concatenate(obj),
        np.concatenate(ids),
        np.concatenate(act),
    )
