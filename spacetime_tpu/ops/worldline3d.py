"""3D spacetime view of the worldline ring buffer.

The reference planned a 3D render of the (x, y, t) worldline block — the
`worldline3d.glsl` shader exists as an includes-only stub, and the archived
host design carries `ModelVertex { spacetime_pos: [f32; 3] }` vertices
(reference: src/twoplusone/worldline/worldline3d.glsl:1-7,
object_archive.txt:102-106).  This module completes that capability: an
orthographic view of every stored worldline sample as a point in
(x, y, t)-space, azimuth/elevation free camera, nearest-sample-wins hidden
surface via a depth-packed scatter-min.

Shape:
- The history is consumed as dense (A, N) component planes sliced straight
  from the mirrored (2T, N) ring — no per-sample gathers anywhere.
- Hidden-surface removal is ONE `at[].min` scatter of an int32 key packing
  (quantized depth << 15 | r5 << 10 | g5 << 5 | b5): the winner carries its
  own color, so decoding the image is pure elementwise shift/mask — no
  per-pixel table lookups.
- Age shading (samples fade toward the white background with lookback) gives
  the depth cue the reference's planned mesh normals would have.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..camera import Camera
from ..state import Objects
from .worldline import WorldlineBuffer

# numpy, not jnp: a module-level jnp constant would initialize the XLA
# backend at import (see ops/raytrace.py's _BIG note)
_BG = np.int32(1) << 28  # > any packed sample (depth 12 | rgb 15 = 27 bits)
_ON_SCREEN_SENTINEL = 1e30  # masks off-screen samples out of the depth range


@dataclasses.dataclass(frozen=True)
class Worldline3DParams:
    """Static view parameters (hashable: baked into the compiled frame).

    `elevation` pi/2 looks straight down the time axis (the ordinary 2D
    view); 0 is edge-on with the past extending down-screen.  `azimuth`
    spins the spatial plane about the time axis.  `time_scale` converts one
    lightsecond of lookback into vertical lightseconds on screen."""

    azimuth: float = 0.65  # radians about the t axis
    elevation: float = 0.95  # radians; pi/2 = top-down
    time_scale: float = 0.35
    max_age: int = 0  # ticks of history drawn; 0 = the full ring
    age_stride: int = 1  # draw every k-th tick (cheap long-history views)
    fade: float = 0.8  # 0 = flat colors, 1 = oldest samples fully white
    shell_only: bool = True  # boundary particles only (the "mesh shell"
    # intent, reference worldline/mod.rs:37-44); False draws solid interiors


@partial(
    jax.jit,
    static_argnames=("width", "height", "params"),
)
def render_worldline3d(
    buf: WorldlineBuffer,
    object_index: jax.Array,
    objects: Objects,
    cam: Camera,
    width: int,
    height: int,
    params: Worldline3DParams,
    active: Optional[jax.Array] = None,
    boundary: Optional[jax.Array] = None,
) -> jax.Array:
    """(H, W, 3) f32 image in [0, 1]: the spacetime block seen side-on.

    `cam.pos`/`cam.zoom` pan and scale the spatial axes exactly like the 2D
    modes, so the same camera controller drives this view.  `boundary`
    (N,) bool selects shell samples when params.shell_only.
    """
    t_cap = buf.capacity
    n = buf.num_particles
    a_all = t_cap if params.max_age <= 0 else min(params.max_age, t_cap)
    col0 = buf.cursor + 1 + (t_cap - a_all)  # slice rows hold ages A-1 .. 0
    stride = max(1, params.age_stride)

    # dense (A, N) component planes straight off the mirrored ring; the
    # stride anchors at the NEWEST row (age 0 — the present-time front face
    # of the block must always draw), so offset by (a_all-1) % stride
    off = (a_all - 1) % stride
    sx = jax.lax.dynamic_slice(buf.pos_x, (col0, 0), (a_all, n))[off::stride]
    sy = jax.lax.dynamic_slice(buf.pos_y, (col0, 0), (a_all, n))[off::stride]
    age = jnp.arange(a_all - 1, -1, -1, dtype=jnp.float32)[off::stride, None]

    # tick spacing from the ring's stored times (newest two slots); prefill
    # rings carry uniform spacing so this is exact
    t_new = buf.times[buf.cursor]
    t_prev = buf.times[(buf.cursor - 1) % t_cap]
    tick = jnp.where(
        jnp.isfinite(t_prev), jnp.maximum(t_new - t_prev, 1e-9), 1.0
    )

    hi = jnp.minimum(buf.frames_in_use - 1, a_all - 1).astype(jnp.float32)
    valid = age <= hi  # (A', 1): unwritten slots hold 1e9 but mask anyway
    if active is not None:
        valid = valid & active[None, :]
    if params.shell_only and boundary is not None:
        valid = valid & boundary[None, :]

    # (x, y, t) relative to the camera center, t = -lookback (past below)
    rx = sx - cam.pos[0]
    ry = sy - cam.pos[1]
    rt = -age * tick * params.time_scale  # (A', 1), broadcasts

    ca, sa = jnp.cos(params.azimuth), jnp.sin(params.azimuth)
    ce, se = jnp.cos(params.elevation), jnp.sin(params.elevation)
    xr = ca * rx + sa * ry
    yr = -sa * rx + ca * ry
    u = xr
    v = yr * se - rt * ce  # elevation pi/2: v = yr (top-down)
    depth = -(yr * ce + rt * se)  # smaller = nearer; top-down: depth = age

    larger = max(width, height)
    scale = larger / cam.zoom
    xi = jnp.round(u * scale + (width - 1) / 2.0).astype(jnp.int32)
    yi = jnp.round(v * scale + (height - 1) / 2.0).astype(jnp.int32)
    inside = valid & (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)

    # quantized depth, normalized to the DRAWN samples' actual range: a
    # fixed zoom-based bound clamps at low elevation (|yr| is unconstrained
    # by the screen there), and clamped samples would occlude by packed
    # color instead of nearness
    big = jnp.float32(_ON_SCREEN_SENTINEL)
    d_lo = jnp.min(jnp.where(inside, depth, big))
    d_hi = jnp.max(jnp.where(inside, depth, -big))
    span = jnp.maximum(d_hi - d_lo, 1e-6)
    dq = jnp.clip(
        jnp.round((depth - d_lo) / span * 4095.0), 0.0, 4095.0
    ).astype(jnp.int32)

    # per-sample color: object base color faded toward white with lookback
    base = objects.base_color[object_index]  # (N, 3) row gather, once
    f = (age / jnp.maximum(hi, 1.0)) * params.fade  # (A', 1) in [0, fade]
    f = jnp.clip(f, 0.0, 1.0)

    def chan(c):  # (N,) -> (A', N) 5-bit faded channel
        plane = c[None, :] * (1.0 - f) + f
        return jnp.round(jnp.clip(plane, 0.0, 1.0) * 31.0).astype(jnp.int32)

    packed = (
        (dq << 15)
        | (chan(base[:, 0]) << 10)
        | (chan(base[:, 1]) << 5)
        | chan(base[:, 2])
    )

    lin = jnp.where(inside, yi * width + xi, width * height)
    flat = jnp.full((width * height + 1,), _BG, jnp.int32)
    flat = flat.at[lin.ravel()].min(packed.ravel(), mode="drop")
    flat = flat[: width * height]

    hit = flat < _BG
    r = ((flat >> 10) & 31).astype(jnp.float32) / 31.0
    g = ((flat >> 5) & 31).astype(jnp.float32) / 31.0
    b = (flat & 31).astype(jnp.float32) / 31.0
    img = jnp.stack(
        [jnp.where(hit, r, 1.0), jnp.where(hit, g, 1.0), jnp.where(hit, b, 1.0)],
        axis=-1,
    )
    return img.reshape(height, width, 3)
