"""Worldline history ring buffer in HBM.

The reference's (archived) design keeps per-frame geometry slices in GPU ring
buffers with `frames_stored` slots, `frames_in_use` ramp-up and a wrapping
`current_frame` cursor, re-uploading one slice per frame
(reference: src/twoplusone/object_archive.txt:108-171).  Its live WIP shader
was meant to extrude softbody boundaries into an (x, y, t) triangle mesh for
a hardware raytracer (reference: src/twoplusone/worldline/mod.rs:37-44,
raytrace.glsl) but never writes output
(worldline_updatesoftbodies.glsl:37-81).

Redesign: no mesh at all.  Each stored tick keeps every particle's
(pos, vel); between consecutive ticks a particle's worldline is a linear
segment in (x, y, t), and a softbody is rendered as the union of
radius-``rho`` capsules swept along those segments.  This is *exact* for the
union-of-discs geometry, sidesteps the boundary-meshing problem the reference
author got stuck on (OLD_worldline_updatesoftbodies.glsl:119-123 "god how am
I supposed to make this work"), and preserves per-particle velocity for
Doppler shading at the retarded event.

Layout:
  * TIME-major planes ``(2T, N)``, one per scalar component — no
    (..., 2) vectors.  Time-major makes the per-tick push write two
    CONTIGUOUS rows (a particle-major layout would write a strided column
    through the whole ring) and lets the renderer's dense cone sweep read
    a contiguous row block.
  * The time axis is MIRRORED (slot s also written at s + T), so any
    backward-window read of up to T ticks is contiguous — no modular
    wraparound in the hot path.
  * Ticks are uniformly spaced `dt` apart (push once per physics step);
    `times[slot]` records each slot's coordinate time and ring-consistency
    is validated from it.

The per-tick update is one two-row `dynamic_update_slice` per plane.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..state import Particles


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class WorldlineBuffer:
    pos_x: jax.Array  # (2T, N) f32, mirrored time axis (dim 0)
    pos_y: jax.Array  # (2T, N)
    vel_x: jax.Array  # (2T, N)
    vel_y: jax.Array  # (2T, N)
    times: jax.Array  # (T,) f32 — coordinate time per slot (-inf = unused)
    cursor: jax.Array  # () i32 — slot holding the newest tick
    frames_in_use: jax.Array  # () i32 — ramp-up counter (object_archive.txt:150)

    @property
    def capacity(self) -> int:
        return self.times.shape[0]

    @property
    def num_particles(self) -> int:
        return self.pos_x.shape[1]


def create(capacity: int, num_particles: int) -> WorldlineBuffer:
    """Empty history. `capacity` is the `frames_stored` analog
    (object_archive.txt:118); it bounds how far into the past rays can see:
    max view radius = capacity * dt lightseconds."""
    plane = lambda fill: jnp.full((2 * capacity, num_particles), fill, jnp.float32)
    return WorldlineBuffer(
        pos_x=plane(1e9),
        pos_y=plane(1e9),
        vel_x=plane(0.0),
        vel_y=plane(0.0),
        times=jnp.full((capacity,), -jnp.inf, jnp.float32),
        cursor=jnp.int32(capacity - 1),
        frames_in_use=jnp.int32(0),
    )


def _set_row(plane, slot, values, t_cap):
    """Write `values` (N,) at slots slot and slot + T (mirror) — two
    contiguous row writes."""
    v = values[None, :]
    plane = jax.lax.dynamic_update_slice(plane, v, (slot, 0))
    return jax.lax.dynamic_update_slice(plane, v, (slot + t_cap, 0))


@jax.jit
def push_raw(buf: WorldlineBuffer, pos, vel, present, time) -> WorldlineBuffer:
    """Store one tick of (pos (N,2), vel (N,2)) with an explicit presence mask
    (the `add_frame` analog, object_archive.txt:173-178: cursor advances with
    wraparound, in-use count saturates at capacity).  Slots not `present` are
    parked far away so the renderer never sees them."""
    t_cap = buf.capacity
    cursor = (buf.cursor + 1) % t_cap
    px = jnp.where(present, pos[:, 0], 1e9)
    py = jnp.where(present, pos[:, 1], 1e9)
    return WorldlineBuffer(
        pos_x=_set_row(buf.pos_x, cursor, px, t_cap),
        pos_y=_set_row(buf.pos_y, cursor, py, t_cap),
        vel_x=_set_row(buf.vel_x, cursor, vel[:, 0], t_cap),
        vel_y=_set_row(buf.vel_y, cursor, vel[:, 1], t_cap),
        times=buf.times.at[cursor].set(jnp.float32(time)),
        cursor=cursor,
        frames_in_use=jnp.minimum(buf.frames_in_use + 1, t_cap),
    )


def push_frame(
    buf: WorldlineBuffer, particles: Particles, time, present=None
) -> WorldlineBuffer:
    """Store the current physics tick.  `present` defaults to the physics
    active mask; engines with aloofbodies pass active | aloof."""
    if present is None:
        present = particles.active
    return push_raw(buf, particles.pos, particles.vel, present, time)


@jax.jit
def prefill_inertial(
    buf: WorldlineBuffer, pos, vel, present, t0, dt
) -> WorldlineBuffer:
    """Warm-start: fill the whole ring assuming bodies were INERTIAL before
    t0 (pos(t) = pos0 + vel*(t - t0)).  Without this a fresh engine renders
    pure background until the camera's past light cone fills with stored
    ticks — physically correct but useless for a cold start."""
    t_cap = buf.capacity
    n = pos.shape[0]
    # slot k holds time t0 - (t_cap - 1 - k) * dt; cursor = t_cap - 1
    rel_t = (jnp.arange(t_cap, dtype=jnp.float32) - (t_cap - 1)) * dt  # <= 0
    rel2 = jnp.concatenate([rel_t, rel_t])  # mirrored

    def fill(p, v):
        out = p[None, :] + v[None, :] * rel2[:, None]
        return jnp.where(present[None, :], out, 1e9)

    return WorldlineBuffer(
        pos_x=fill(pos[:, 0], vel[:, 0]),
        pos_y=fill(pos[:, 1], vel[:, 1]),
        vel_x=jnp.broadcast_to(vel[:, 0][None, :], (2 * t_cap, n)),
        vel_y=jnp.broadcast_to(vel[:, 1][None, :], (2 * t_cap, n)),
        times=t0 + rel_t,
        cursor=jnp.int32(t_cap - 1),
        frames_in_use=jnp.int32(t_cap),
    )


def slot_of_age(buf: WorldlineBuffer, age):
    """Slot index holding the tick `age` steps before the newest (age 0 =
    newest). Valid while age < frames_in_use."""
    return (buf.cursor - age) % buf.capacity


def pos_at_age(buf: WorldlineBuffer, age):
    """(N, 2) positions at a given age (row dynamic-slice, no gather)."""
    slot = slot_of_age(buf, age)
    x = jax.lax.dynamic_slice_in_dim(buf.pos_x, slot, 1, axis=0)[0]
    y = jax.lax.dynamic_slice_in_dim(buf.pos_y, slot, 1, axis=0)[0]
    return jnp.stack([x, y], axis=-1)


def boundary_mask(particles: Particles) -> jax.Array:
    """(N,) bool: particles on the softbody surface.

    The reference's WIP shaders identify boundary geometry by probing the
    collision grid for same-object occupancy around each particle
    (worldline_updatesoftbodies.glsl:55-77, OLD_...glsl:135-153).  The bond
    table already encodes exactly that neighborhood: a particle with any
    missing bond slot is on the surface (or next to a tear).  O(N) and exact
    on the import lattice.
    """
    return particles.active & jnp.any(particles.neighbors < 0, axis=-1)
