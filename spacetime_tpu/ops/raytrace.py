"""Retarded-time raytracer over the worldline ring buffer.

This implements the capability the reference left as an empty stub
(reference: src/twoplusone/worldline/raytrace.glsl:11-21 — bindings and a
resources list, no code): Lorentz-correct retarded-time visibility per the
north star in BASELINE.json.

Physical model.  The world is 2D; the image is the standard top-down "god
view" map of the plane (same convention as the reference's debug point
renderer), but what is shown at map point ``p`` is what an observer at the
camera position ``c`` actually *sees* of ``p`` at coordinate time ``t_now``:
the event ``(p, t_now - |p - c|)`` on the camera's past light cone.  A pixel
ray in (x, y, t) runs from the camera event along direction ``(d_hat, -1)``
— slope c, exactly the construction sketched in SURVEY.md §5.

Geometry.  Softbodies are unions of radius-``rho`` discs centered on
particles; between stored ticks each disc sweeps a linear capsule in
(x, y, t).  Ray-capsule intersection is closed form: with ``tau`` the within-
segment time fraction, both the ray point and the particle position are
affine in ``tau``, so squared distance is quadratic — one clamp + one
division per candidate.  This replaces the reference's unfinished
boundary-mesh + BVH design (worldline/mod.rs:37-44,
object_archive.txt:249-287) with something exact for the disc-union geometry
and regular enough to run as dense array programs.

Acceleration structure (no BVH, no dynamic stacks):
  1. *Light-cone band search* — because |v| < c while the cone radius grows
     at exactly c per tick, f(age) = dist(age) - age*dt is strictly monotone:
     each worldline crosses the cone in EXACTLY ONE contiguous tick band.  A
     dense sweep over the swept ages plus a window extraction yields all
     candidate segments in a static (N, band) layout — no (T, N) candidate
     mask, no compaction scatter.
  2. *View-cell binning* — candidate segments splat (one sort by a
     (cell, distance-quantile) key) into cells that COINCIDE with cell_px^2
     pixel blocks of the image, so pixel <-> candidate matching is pure index
     arithmetic.
  3. *1D retina* — the camera is a point, so occlusion needs one first-hit
     march per ANGLE (``num_rays``), not per pixel.  Rays test the candidate
     list as a dense chunked broadcast (exact).
  4. *Per-pixel retarded occupancy* — each k x k pixel block tests its own
     cell's candidates: either the XLA block map below or the fused kernel
     in ops/pixel_triton.py (paths.py chooses by platform).

Total work is O(N T_swept + pairs log pairs + rays*pairs + pixels*capacity).

Hot-path arrays are scalar component planes (separate x / y / r / g / b
arrays) rather than (..., 2) or (..., 3) tensors.  Public image output is
(H, W, 3) by default; `planar=True` returns (3, H, W).

Shading: special-relativistic Doppler (source motion composed with observer
motion) with an approximate spectral shift of the RGB channels, plus
headlight beaming ``D**3`` (bolometric intensity boost), per BASELINE
configs 3-4.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..camera import Camera, pixel_centers
from ..constants import C2
from .. import paths
from ..state import Objects
from .worldline import WorldlineBuffer

# numpy scalars, NOT jnp: a module-level jnp constant creates a device array
# at import, which initializes the XLA backend — breaking the
# jax.distributed.initialize() must-be-first contract for multi-process
# runs (parallel/multihost.py); numpy scalars trace identically
_BIG = np.float32(3.0e38)
_PI = np.float32(np.pi)
_DQ = 64  # splat-key distance-quantization levels (nearest-k bin retention)


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Static renderer configuration (hashable -> jit static arg)."""

    dt: float = 0.005  # history tick spacing (= PhysicsParams.h if pushed every step)
    rho: float = 0.0026  # particle render radius; >= half diagonal spacing fills interiors
    band: int = 6  # cone-crossing ticks kept per particle (see _band_pairs);
    # covers radial speeds to ~0.6c — band_truncated in RenderDiag flags overruns
    # keep only the first `segments` VALID crossings per particle (rank
    # compaction, _band_pairs) — `band` slots are still searched, but the
    # pdata layout downstream shrinks to N*segments rows (the mean valid
    # count is ~1.1; segments=2 halves the pdata build + compaction sort at
    # reference-demo scale).  0 = keep all band slots.  Overflow drops the
    # youngest crossings of fast approachers; RenderDiag.segment_dropped
    # flags it and the engine widens on evidence.
    segments: int = 0
    bin_capacity: int = 64  # candidates per spatial hash cell
    num_rays: int = 2048  # 1D retina resolution (occlusion only)
    # pairs per scan chunk in the retina march: bigger chunks amortize the
    # per-chunk reduce/loop overhead
    ray_chunk: int = 8192
    cell_px: int = 16  # view-cell edge in pixels; k*pixel_size must be >= reach
    # compact valid pairs to this budget before the splat sort when the raw
    # N*band layout is larger (0 = never compact); bounds the binning cost at
    # large particle counts (reference demo scale: 686k slots -> 131k)
    pair_budget: int = 131072
    # static cap on SORTED splat entries kept for binning (0 = all
    # pair_budget * splat_cells entries).  Invalid keys sort to the END, so
    # a prefix slice of the sorted entries keeps every valid one while they
    # fit, and the binning after the sort runs on the smaller slice.
    # Overflow (valid entries beyond the budget) drops whole high-index
    # cells — spatially coherent image loss — so RenderDiag.entry_dropped
    # flags it and the engine doubles the budget on evidence.
    entry_budget: int = 0
    cells_per_block: int = 512  # view cells per lax.map block (bounds HBM)
    # BTZ mode only: also render routes reflected ONCE off the AdS
    # conformal boundary (ops/btz.py ROUTES) — a third/fourth image per
    # emitter at longer delays.  Doubles the band searches and the
    # per-pixel route work; needs history >= the bounce delay in ticks.
    btz_reflections: bool = False
    # BTZ mode only: extra full windings around the hole per route family —
    # the 2+1 analog of higher-order photon-ring images (ops/btz.py
    # _orbit_setup: route // 4 = winding).  k windings multiply the band
    # searches and per-pixel route work by (k + 1); each winding's images
    # arrive ~2 pi l / sqrt(M)-class delays later, so history must cover it.
    btz_windings: int = 0
    # BTZ mode only: solve the FULL rotating metric per route
    # (ops/btz_exact.py: closed-form integrals + branch-bracketed
    # bisection) instead of the O(J^2) slow-rotation model — exact at any
    # |J| < M l, including near-extremal spins where the drag model breaks
    # down.  ~100x the delay-evaluation cost (still dense elementwise math).
    btz_exact_spin: bool = False
    opaque: bool = True  # False = x-ray: no occlusion shading
    retarded: bool = True  # False = instantaneous view of the newest tick
    # camera-frame (boosted) map view: plot every past-cone event at its
    # position in the camera's INSTANTANEOUS REST FRAME instead of the
    # ground frame (ops/boost.py — the reference's archived observer-frame
    # `Perspective` intent, object_archive.txt:20-99).  Exact closed-form
    # invertible warp: pair splat centers warp forward, pixel query points
    # warp back; occupancy/occlusion/shading all evaluate in ground
    # coordinates, so no new approximation beyond the conservative splat
    # reach stretch gamma*(1+|v|).  Requires retarded=True (an
    # instantaneous boosted view would need a per-event simultaneity
    # re-slice, which the ring stores no data for).  Flat spacetime only.
    camera_frame: bool = False
    # pixel-pass backend: "auto" = the platform's choice (paths.py);
    # "xla" / "triton" name one explicitly
    backend: str = "auto"
    # tests only: run the Triton pixel pass in Pallas interpret mode (CPU)
    triton_interpret: bool = False
    # occlusion retina lookup granularity: 1 = per pixel (exact); d = one
    # lookup per d x d pixel quad (at the quad center angle — the radial
    # blocked test stays per-pixel exact).  d=2 quarters the lookups for
    # <= 1 px of angular shadow-edge jitter (the 4096-ray retina itself
    # quantizes edges to ~1.6 px at screen edge).  Ignored unless it divides
    # cell_px; ACCURACY.md documents the envelope.
    occlusion_downsample: int = 2
    # cells each candidate splats into: 9 (3x3 around the center cell —
    # always exact) or 4 (nearest-corner 2x2 — exact iff reach <= cell/2,
    # i.e. a capsule never extends past the adjacent cell; RenderDiag's
    # cell_too_small flags violations).  4 nearly halves the binning
    # sort/scatter volume at reference demo scale.
    splat_cells: int = 9
    # oldest worldline age (ticks) the cone sweep scans; 0 = the full ring.
    # Light can only arrive from within max_view_distance/dt ticks, so a
    # view-derived bound skips most of a long history's sweep (the sweep
    # reads 4 (N, T) planes per frame).  Must cover the
    # farthest visible point + margin or distant matter silently vanishes
    # (engine._render_params derives it from the zoom each frame).
    max_age: int = 0
    # occlusion-retina pair budget when a boundary mask is supplied: only
    # SURFACE particles' capsules can be first hits (interior discs sit
    # behind an overlapping boundary layer: rho 0.0026 > spacing/2), so the
    # retina march runs over boundary pairs compacted to this budget —
    # the worldline-meshgen "extrude the boundary" idea of the reference
    # (worldline/mod.rs:37-44) recast as candidate culling.  0 = march all
    # pairs.  RenderDiag.retina_dropped flags overflow, and the engine
    # doubles the budget on evidence (engine._check_diag).
    retina_budget: int = 8192
    doppler: bool = True
    beaming: bool = True
    doppler_strength: float = 1.0
    # physically-based spectral Doppler (opt-in, ACCURACY.md #10 upgrade):
    # each surface emits as a blackbody at `spectral_temp` kelvin tinted by
    # its albedo; the observed channel photometry is the EXACT frequency-form
    # Planck ratio under the total Doppler factor D (shade_channels), which
    # includes relativistic beaming exactly (the 3-band hat model and the
    # D^3 beaming flag are ignored in this mode).
    spectral: bool = False
    spectral_temp: float = 6500.0  # rest-frame emitter temperature (K)
    ambient: float = 0.15  # fraction of unshifted base color mixed in
    absorbed_dim: float = 0.35  # brightness of matter hidden behind other matter
    shadow: float = 0.78  # background brightness in occluded regions

    @property
    def reach(self) -> float:
        """Max capsule reach: rho + half a max-speed tick of motion."""
        return self.rho + 0.5 * self.dt


def min_cell_edge(params: RenderParams) -> float:
    """Least view-cell edge (world units) for which splatting is exact: a
    3x3 splat needs reach, a nearest-corner 2x2 splat twice that."""
    return params.reach * (2.0 if params.splat_cells == 4 else 1.0)


def auto_cell_px(params: RenderParams, width: int, height: int, zoom: float) -> int:
    """Smallest view-cell edge (pixels) satisfying the coverage constraint
    cell_px * pixel_size >= min_cell_edge, so a capsule splatted into its
    cells is visible from every pixel it can cover."""
    pixel_size = zoom / max(width, height)
    return max(1, int(-(-min_cell_edge(params) // pixel_size)))


class RenderDiag(NamedTuple):
    pairs_used: jax.Array  # valid cone-crossing segments this frame
    band_truncated: jax.Array  # particles whose crossing outlasts the band
    bin_dropped: jax.Array  # splat entries beyond bin_capacity
    cell_too_small: jax.Array  # bool: cell_px violates the coverage constraint
    retina_dropped: object = None  # boundary pairs beyond retina_budget
    entry_dropped: object = None  # valid splat entries beyond entry_budget
    segment_dropped: object = None  # valid crossings beyond params.segments


# ---------------------------------------------------------------------------
# Scalar-component shading
# ---------------------------------------------------------------------------


def _gamma_xy(vx, vy):
    return 1.0 / jnp.sqrt(jnp.maximum(1.0 - (vx * vx + vy * vy) / C2, 1e-12))


def doppler_factor_xy(vx, vy, nx, ny):
    """Observed/emitted frequency for a source at velocity (vx, vy), photon
    propagation direction (nx, ny) (unit, source -> observer), static
    observer (relativity.doppler_factor, componentized)."""
    g = _gamma_xy(vx, vy)
    return 1.0 / (g * (1.0 - (vx * nx + vy * ny) / C2))


def camera_doppler_factor_xy(cvx, cvy, nx, ny):
    """Moving-observer factor (relativity.camera_doppler_factor)."""
    g = _gamma_xy(cvx, cvy)
    return g * (1.0 - (cvx * nx + cvy * ny) / C2)


def _hat(x):
    """Linear hat weight max(0, 1 - |x|) for the spectral-shift resample."""
    return jnp.maximum(0.0, 1.0 - jnp.abs(x))


# representative channel wavelengths (m) and h*c/k (m*K) for the spectral
# (blackbody) Doppler model
_LAMBDA_RGB = (610e-9, 550e-9, 465e-9)
_HC_OVER_K = 1.43877688e-2


def planck_channel_factor(d, lam: float, temp: float):
    """Observed/emitted intensity ratio at channel wavelength `lam` for a
    blackbody emitter at rest temperature `temp` seen under total Doppler
    factor `d` — EXACT relativistic photometry, beaming included.

    Derivation: specific intensity transforms as I'_nu'(nu') = D^3 I_nu(nu'/D)
    with B_nu(nu, T) ~ nu^3 / expm1(h nu / k T), so at the fixed observed
    channel frequency nu_c the ratio to the rest-frame emission is
        I'(nu_c) / I(nu_c) = expm1(x_c) / expm1(x_c / D),  x_c = h nu_c / k T
    (the D^3 beaming and the nu^3 prefactor cancel).  At D = 1 this is
    exactly 1 (albedo identity); blueshift brightens shorter wavelengths
    more (larger x_c).

    Numerics (ADVICE r4): the naive expm1(x)/expm1(x/D) overflows float32
    for x > 88 (spectral_temp below ~360 K at visible wavelengths -> NaN
    frames).  Rewritten as exp(x - x/D) * (1 - e^-x) / (1 - e^-x/D), which
    is finite everywhere; the exponent is clamped at +-80 (exp(80) ~ 5e34 —
    the shade path clips channel values to [0, 1] long before that)."""
    x = _HC_OVER_K / (lam * temp)
    d_safe = jnp.maximum(d, 1e-3)
    expo = jnp.clip(x - x / d_safe, -80.0, 80.0)
    num = -jnp.expm1(-x)
    den = -jnp.expm1(-x / d_safe)
    return jnp.exp(expo) * num / jnp.maximum(den, 1e-38)


def shade_channels(cr, cg, cb, d, params: RenderParams):
    """Doppler-shift + beam three scalar channel arrays.

    Spectral model: (r, g, b) are three frequency bands (increasing); a
    Doppler factor D translates energy across them by log2(D) channels with
    linear interpolation; light shifted outside the triplet dims to black.
    out_i = sum_j hat(i - t - j) * c_j  with t = clip(log2 D).
    """
    if params.spectral:
        # blackbody photometry (see planck_channel_factor): albedo tints a
        # thermal emitter at spectral_temp; beaming is inherent in the
        # frequency-form ratio, so the D^3 flag does not apply here
        t0 = params.spectral_temp
        sr = cr * planck_channel_factor(d, _LAMBDA_RGB[0], t0)
        sg = cg * planck_channel_factor(d, _LAMBDA_RGB[1], t0)
        sb = cb * planck_channel_factor(d, _LAMBDA_RGB[2], t0)
    elif params.doppler:
        t = jnp.clip(
            jnp.log2(jnp.maximum(d, 1e-6)) * params.doppler_strength, -2.5, 2.5
        )
        out = []
        for i in range(3):
            src = i - t
            out.append(_hat(src - 0) * cr + _hat(src - 1) * cg + _hat(src - 2) * cb)
        sr, sg, sb = out
    else:
        sr, sg, sb = cr, cg, cb
    if params.beaming and not params.spectral:
        boost = d * d * d
        sr, sg, sb = sr * boost, sg * boost, sb * boost
    amb = params.ambient
    mix = lambda s, c: amb * c + (1.0 - amb) * jnp.clip(s, 0.0, 1.0)
    return mix(sr, cr), mix(sg, cg), mix(sb, cb)


def doppler_shift_rgb(rgb, d_factor, strength=1.0):
    """Vector-form spectral shift (used by tests/small paths)."""
    params = RenderParams(doppler=True, beaming=False, ambient=0.0,
                          doppler_strength=strength)
    r, g, b = shade_channels(
        rgb[..., 0], rgb[..., 1], rgb[..., 2], d_factor, params
    )
    return jnp.stack([r, g, b], axis=-1)


def shade_hit(base_color, vel_event, n_hat, cam_vel, params: RenderParams):
    """Vector-form shading (oracle / tests).  `n_hat` (..., 2) is the photon
    propagation direction (event -> camera); total Doppler = source factor x
    moving-observer factor (a co-moving camera sees no shift)."""
    d = jnp.ones(base_color.shape[:-1], base_color.dtype)
    if params.doppler or params.beaming:
        d = doppler_factor_xy(
            vel_event[..., 0], vel_event[..., 1], n_hat[..., 0], n_hat[..., 1]
        ) * camera_doppler_factor_xy(
            cam_vel[..., 0], cam_vel[..., 1], n_hat[..., 0], n_hat[..., 1]
        )
    r, g, b = shade_channels(
        base_color[..., 0], base_color[..., 1], base_color[..., 2], d, params
    )
    return jnp.stack([r, g, b], axis=-1)


# ---------------------------------------------------------------------------
# Scalar-component segment math (shared by oracle and accelerated path)
# ---------------------------------------------------------------------------


def _segment_data(buf: WorldlineBuffer, dt: float):
    """Per-(slot, particle) segment endpoint components in slot order,
    materialized as (T, N) — oracle/tests only; the accelerated path uses
    the band search instead.

    Segment owned by slot k runs from (pos[k], times[k]) to
    (pos[(k+1) % T], times[k] + dt); valid iff the next slot holds the
    consecutive tick (ring wraparound and ramp-up slots fail this)."""
    t_cap = buf.capacity
    nxt = (jnp.arange(t_cap) + 1) % t_cap
    ta = buf.times
    valid = jnp.isfinite(ta) & (jnp.abs(buf.times[nxt] - ta - dt) < 0.5 * dt)
    qax = buf.pos_x[:t_cap]  # (T, N); first half of the mirror = slots
    qay = buf.pos_y[:t_cap]
    return qax, qay, qax[nxt], qay[nxt], ta, valid


def _ray_hit_xy(cx, cy, dhx, dhy, ax, ay, bx, by, ta, t_now, dt, rho):
    """Ray (origin camera, direction (dhx, dhy)) on the past light cone of
    (cam, t_now) vs one swept capsule, all scalar components.  Event times
    [ta, ta+dt] map to arclength s = t_now - t in [s_hi - dt, s_hi]; both ray
    point and particle position are affine in the segment fraction tau, so
    |A - tau B|^2 minimizes in closed form.  Returns (hit, s_hit)."""
    s_hi = t_now - ta
    a_x = cx + s_hi * dhx - ax
    a_y = cy + s_hi * dhy - ay
    b_x = dt * dhx + (bx - ax)
    b_y = dt * dhy + (by - ay)
    bb = b_x * b_x + b_y * b_y
    tau = jnp.clip((a_x * b_x + a_y * b_y) / jnp.maximum(bb, 1e-20), 0.0, 1.0)
    d_x = a_x - tau * b_x
    d_y = a_y - tau * b_y
    dist2 = d_x * d_x + d_y * d_y
    s_hit = s_hi - tau * dt
    hit = (dist2 <= rho * rho) & (s_hit > 0.0)
    return hit, s_hit


def _occupancy_xy(px, py, t_e, ax, ay, bx, by, ta, dt, rho):
    """Is map point (px, py) inside this segment's capsule at event time t_e?
    Returns (inside, dist2)."""
    tau = (t_e - ta) / dt
    in_time = (tau >= -0.001) & (tau <= 1.001)
    tau_c = jnp.clip(tau, 0.0, 1.0)
    d_x = px - (ax + tau_c * (bx - ax))
    d_y = py - (ay + tau_c * (by - ay))
    dist2 = d_x * d_x + d_y * d_y
    return in_time & (dist2 <= rho * rho), dist2


# ---------------------------------------------------------------------------
# Shared pixel-pass machinery (view-cell aligned)
# ---------------------------------------------------------------------------
#
# The image is tiled into k x k pixel blocks (k = cell_px) that coincide
# exactly with the candidate binning cells, so pixel <-> candidate matching
# is pure index arithmetic and candidate data is fetched once per CELL
# instead of once per pixel.


class ViewTables(NamedTuple):
    """Per-frame candidate data densified onto the image's view-cell grid."""

    vdat: jax.Array  # (n_img_cells_padded, cap, 10) f32 packed pair rows
    vok: jax.Array  # (n_img_cells_padded, cap) bool
    n_img_cells: int  # before padding (static)


_F_AX, _F_AY, _F_BX, _F_BY, _F_TA, _F_VX, _F_VY, _F_CR, _F_CG, _F_CB = range(10)


def _euclid_route(cx, cy):
    """Flat-spacetime route length: the Euclidean chord to the camera (the
    default light-cone metric; curved modes pass their own closed forms)."""
    return lambda qx, qy: jnp.sqrt((qx - cx) ** 2 + (qy - cy) ** 2)


def _cone_band_window(buf: WorldlineBuffer, route_lengths, params: RenderParams,
                      cam=None):
    """Find each particle's cone-crossing tick band and fetch its window.

    Returns (a0, hi0, truncated, (wx, wy, wvx, wvy, ages)) where the window
    arrays are (N, band+1) ticks covering ages [a0-1, a0+band-1].

    Search: ONE DENSE sweep over the (N, T) age block — f(age) =
    route(pos(age)) - age*dt evaluated on a contiguous slice of the mirrored
    (2T, N) planes, then a masked min/max reduction.

    Window fetch: MASKED-REDUCE extraction from the same dense slices —
    wx[:, j] = sum_t s[:, t] * (t == c0 + j) — which fuses into the passes
    over data the sweep already reads.
    """
    dt, rho, band = params.dt, params.rho, params.band
    t_cap = buf.capacity
    n = buf.num_particles
    thresh = rho + dt
    base_col = buf.cursor + t_cap  # mirrored column of age 0
    hi0 = jnp.minimum(buf.frames_in_use - 1, t_cap - 1)

    # swept age range: ages [0, A) — a view-derived max_age skips the part
    # of a long history no light cone from the view can reach
    a_sw = t_cap if params.max_age <= 0 else min(params.max_age, t_cap)
    col0 = buf.cursor + 1 + (t_cap - a_sw)  # slice holds ages A-1 .. 0
    # clamp the usable age range to the sweep so no window column (or its
    # younger endpoint) can reference an unswept tick: out-of-slice columns
    # extract as 0.0 and would otherwise ghost through the annulus test
    hi0 = jnp.minimum(hi0, a_sw - 1)
    w = band + 1

    if route_lengths is None:
        route_lengths = _euclid_route(cam.pos[0], cam.pos[1])

    # --- dense cone sweep over the swept rows (time-major planes) ---
    sx = jax.lax.dynamic_slice(buf.pos_x, (col0, 0), (a_sw, n))
    sy = jax.lax.dynamic_slice(buf.pos_y, (col0, 0), (a_sw, n))
    age_row = jnp.arange(a_sw - 1, -1, -1, dtype=jnp.int32)[:, None]
    f = route_lengths(sx, sy) - age_row.astype(jnp.float32) * dt
    in_range = (age_row >= 1) & (age_row <= hi0)
    enter = (f <= thresh) & in_range
    a0 = jnp.min(jnp.where(enter, age_row, hi0 + 1), axis=0)
    # oldest still-crossing age (for band-truncation diagnostics)
    crossing = enter & (f >= -thresh)
    a_last = jnp.max(jnp.where(crossing, age_row, -1), axis=0)
    truncated = jnp.sum((a_last >= a0 + band).astype(jnp.int32))

    # --- window fetch: ages [a0+band-1 .. a0-1] as ascending columns ---
    start_col = jnp.clip(base_col - (a0 + band - 1), 0, 2 * t_cap - w)
    ages = base_col - (
        start_col[:, None] + jnp.arange(w, dtype=jnp.int32)[None, :]
    )
    # window column j (mirrored coords start_col + j) sits at slice row
    # c0 + j; rows outside the slice (clipped starts / age >= A / age < 0)
    # extract as 0 and are masked by the age-range validity downstream
    c0 = start_col - col0  # (N,)
    rel = jnp.arange(a_sw, dtype=jnp.int32)[:, None] - c0[None, :]  # (A, N)

    def window(s):  # (A, N) dense slice -> (N, w)
        return jnp.stack(
            [jnp.sum(jnp.where(rel == j, s, 0.0), axis=0) for j in range(w)],
            axis=1,
        )

    svx = jax.lax.dynamic_slice(buf.vel_x, (col0, 0), (a_sw, n))
    svy = jax.lax.dynamic_slice(buf.vel_y, (col0, 0), (a_sw, n))
    wx = window(sx)  # (N, band+1)
    wy = window(sy)
    wvx = window(svx)
    wvy = window(svy)
    return a0, hi0, truncated, (wx, wy, wvx, wvy, ages)


def _band_pairs(
    buf: WorldlineBuffer,
    obj_index,
    objects,
    cam,
    t_now,
    width: int,
    height: int,
    params: RenderParams,
    route_lengths=None,
    cull_hull: bool = True,
) -> "PairData":
    """Cone-crossing segments via monotonic band search — no (T, N) mask, no
    compaction scatter.

    Because |v| < c while the light-cone radius grows at exactly c per tick,
    f(age) = dist_to_camera(age) - age*dt is strictly decreasing in age, so
    each particle's worldline crosses the cone in EXACTLY ONE contiguous
    band of ticks.  _cone_band_window finds the band start and fetches
    band+1 ticks; validity is re-checked exactly per segment.

    `route_lengths(qx, qy) -> distance` customizes the cone metric (curved
    space); default is Euclidean distance to the camera.
    """
    dt, rho, band = params.dt, params.rho, params.band
    t_cap = buf.capacity
    n = buf.num_particles
    cxm, cym = cam.pos[0], cam.pos[1]

    a0, hi0, truncated, (wx, wy, wvx, wvy, ages) = _cone_band_window(
        buf, route_lengths, params, cam=cam
    )
    if route_lengths is None:
        route_lengths = _euclid_route(cxm, cym)

    # segment j: older endpoint = window[:, j] (age a_j), younger = [:, j+1]
    qax, qay = wx[:, :band], wy[:, :band]
    qbx, qby = wx[:, 1:], wy[:, 1:]
    pvx, pvy = wvx[:, :band], wvy[:, :band]
    age_a = ages[:, :band]  # (N, band)
    pta = t_now - age_a.astype(jnp.float32) * dt

    # exact annulus validity per segment (+ ring-range + view-hull culling)
    ra = route_lengths(qax, qay)
    rb = route_lengths(qbx, qby)
    s_hi = t_now - pta
    valid = (
        (age_a >= 1)
        & (age_a <= hi0)
        & (jnp.maximum(ra, rb) >= s_hi - dt - rho)
        & (jnp.minimum(ra, rb) <= s_hi + rho)
        & (jnp.abs(qax) < 1.0e8)
    )
    if cull_hull:
        # safe for straight rays only: a camera->pixel segment stays inside
        # the view+camera hull.  CURVED routes (conical route 2, BTZ) pass
        # through off-hull regions, so their callers disable this cull —
        # off-screen matter can occlude an on-screen geodesic.
        _, _, pixel_size, x0, y0 = _view_grid(
            width, height, cam, params.cell_px
        )
        margin = 4.0 * (rho + dt)
        vx0 = jnp.minimum(x0, cxm) - margin
        vx1 = jnp.maximum(x0 + width * pixel_size, cxm) + margin
        vy0 = jnp.minimum(y0, cym) - margin
        vy1 = jnp.maximum(y0 + height * pixel_size, cym) + margin
        valid = (
            valid
            & (jnp.maximum(qax, qbx) >= vx0)
            & (jnp.minimum(qax, qbx) <= vx1)
            & (jnp.maximum(qay, qby) >= vy0)
            & (jnp.minimum(qay, qby) <= vy1)
        )

    seg_dropped = None
    k = params.segments
    if 0 < k < band:
        # --- per-particle segment compaction ---------------------------
        # The cone crossing spans (dt + 2*rho) / (dt * (1 - v_r)) ticks, so
        # while `band` slots must be SEARCHED (fast approachers), the mean
        # VALID count is ~1.1 at reference-demo scale — most of the
        # (N, band) pdata rows the stack and the compaction sort
        # pay for are invalid.  Rank-select the first `segments` valid
        # segments per particle with masked sums (pure elementwise — no
        # sorts, no gathers); particles with more valid segments than slots
        # lose their YOUNGEST crossings (sub-pixel trailing-edge loss, the
        # capsule radius rho covers most of it) and are counted in
        # RenderDiag.segment_dropped, which the engine grows `segments` on.
        vcount = jnp.sum(valid.astype(jnp.int32), axis=1)
        rank = jnp.cumsum(valid.astype(jnp.int32), axis=1) - 1
        seg_dropped = jnp.sum(jnp.maximum(vcount - k, 0))

        def sel(f):
            f = f.astype(jnp.float32)
            return jnp.stack(
                [
                    jnp.sum(jnp.where(valid & (rank == s), f, 0.0), axis=1)
                    for s in range(k)
                ],
                axis=1,
            )

        qax, qay = sel(qax), sel(qay)
        qbx, qby = sel(qbx), sel(qby)
        pta, pvx, pvy = sel(pta), sel(pvx), sel(pvy)
        valid = vcount[:, None] > jnp.arange(k, dtype=jnp.int32)[None, :]
        band = k

    far = 2.0e9
    keep = lambda v: jnp.where(valid, v, far).reshape(-1)
    prgb = objects.base_color[obj_index]  # (N, 3)
    col = lambda c: jnp.broadcast_to(
        prgb[:, c][:, None], (n, band)
    ).reshape(-1)
    pdata = jnp.stack(
        [
            keep(qax), keep(qay), keep(qbx), keep(qby),
            jnp.where(valid, pta, 0.0).reshape(-1),
            pvx.reshape(-1), pvy.reshape(-1),
            col(0), col(1), col(2),
        ],
        axis=-1,
    )
    return PairData(
        pdata=pdata,
        pair_valid=valid.reshape(-1),
        n_pairs=jnp.sum(valid.astype(jnp.int32)),
    ), truncated, seg_dropped


def _compact_pairs_to_budget(pairs: "PairData", budget: int) -> "PairData":
    """Stream-compact valid pairs into a smaller static layout (cumsum +
    scatter).  Only worth it when pdata rows >> valid pairs: the splat sort
    downstream costs O(rows * 9 log)."""
    rows = pairs.pdata.shape[0]
    if budget <= 0 or budget >= rows:
        return pairs
    mask = pairs.pair_valid
    # stable sort on the 1-bit validity key floats valid rows to the front in
    # original order.  Key and row index PACK into one u32
    # (1 validity bit << 30 | row, rows < 2^30 always) so the sort moves ONE
    # operand instead of two.
    src = jnp.arange(rows, dtype=jnp.uint32)
    packed = ((~mask).astype(jnp.uint32) << 30) | src
    spacked = jax.lax.sort(packed)
    taken = (spacked[:budget] & jnp.uint32((1 << 30) - 1)).astype(jnp.int32)
    ok = (spacked[:budget] >> 30) == 0
    far = 2.0e9
    pdata = jnp.where(ok[:, None], pairs.pdata[taken], far)
    return PairData(
        pdata=pdata,
        pair_valid=ok,
        n_pairs=pairs.n_pairs,  # pre-budget count (diag shows drops)
    )


def _compact_pairs_two_segment(pairs: "PairData", first_mask, budget: int):
    """Compact like _compact_pairs_to_budget but write pairs matching
    `first_mask` at the FRONT of the buffer.  The boundary-only occlusion
    retina then reads a STATIC prefix slice instead of paying a second
    compaction over the raw layout.  Returns (PairData, n_first)."""
    rows = pairs.pdata.shape[0]
    mask = pairs.pair_valid
    fm = mask & first_mask
    n_first = jnp.sum(fm.astype(jnp.int32))
    if budget <= 0 or budget >= rows:
        budget = rows
    # three-way stable sort key: boundary pairs (0) < other valid (1) <
    # invalid (2); order within each class is preserved (lax.sort is
    # stable).  Key and row index PACK into one u32 (2 class bits << 30 |
    # row, rows < 2^30 always): a single-operand sort.
    key = jnp.where(fm, 0, jnp.where(mask, 1, 2)).astype(jnp.uint32)
    src = jnp.arange(rows, dtype=jnp.uint32)
    spacked = jax.lax.sort((key << 30) | src)
    taken = (spacked[:budget] & jnp.uint32((1 << 30) - 1)).astype(jnp.int32)
    ok = (spacked[:budget] >> 30) < 2
    pdata = jnp.where(ok[:, None], pairs.pdata[taken], 2.0e9)
    return PairData(pdata=pdata, pair_valid=ok, n_pairs=pairs.n_pairs), n_first


class PairData(NamedTuple):
    """Cone-crossing segments in the static (N * band) layout.

    Shading inputs (velocity, albedo) are resolved PER PAIR here so the
    per-pixel pass reads them with the winning candidate.  All builders
    emit the 10 _F_* columns."""

    pdata: jax.Array  # (N * band, 10) f32 — see _F_* field order
    pair_valid: jax.Array  # (N * band,)
    n_pairs: jax.Array  # () i32


def _view_grid(width, height, cam, k):
    """Static view-cell grid dims + traced geometry.

    Returns (wc_img, hc_img, pixel_size, x0, y0) where (x0, y0) is the world
    position of pixel (0, 0)'s center."""
    wc_img = -(-width // k)
    hc_img = -(-height // k)
    larger = max(width, height)
    pixel_size = cam.zoom / larger
    x0 = cam.pos[0] - (width - 1) / 2.0 * pixel_size
    y0 = cam.pos[1] - (height - 1) / 2.0 * pixel_size
    return wc_img, hc_img, pixel_size, x0, y0


def _splat_keys(
    pairs: PairData, cam, width: int, height: int, params: RenderParams
):
    """Composite splat keys for the (view cells + halo) grid: one entry per
    (pair, splat offset), key = cell * _DQ + quantized distance (nearest-k
    retention — see _splat_vslot).  Returns
    (key, val, wc, hc, geom, cell_too_small)."""
    k = params.cell_px
    pcap = pairs.pdata.shape[0]
    wc_img, hc_img, pixel_size, x0, y0 = _view_grid(width, height, cam, k)
    wc, hc = wc_img + 2, hc_img + 2  # +1 halo cell each side
    n_vcells = wc * hc
    lam = k * pixel_size  # traced cell edge (world units)
    # halo-grid origin: half a pixel before pixel (0,0), minus one cell
    gx0 = x0 - 0.5 * pixel_size - lam
    gy0 = y0 - 0.5 * pixel_size - lam

    pd = pairs.pdata
    cx = 0.5 * (pd[:, _F_AX] + pd[:, _F_BX])
    cy = 0.5 * (pd[:, _F_AY] + pd[:, _F_BY])
    seg = jnp.sqrt(
        (pd[:, _F_BX] - pd[:, _F_AX]) ** 2 + (pd[:, _F_BY] - pd[:, _F_AY]) ** 2
    )
    reach = params.rho + 0.5 * seg
    if params.camera_frame:
        # camera-frame view: cells live in OUTPUT (boosted) coordinates, so
        # splat the pair's warped center; a ground disc of radius `reach`
        # maps inside a warped disc of radius stretch * reach (ops/boost.py)
        from . import boost

        wux, wuy = boost.warp_xy(
            cx - cam.pos[0], cy - cam.pos[1], cam.vel[0], cam.vel[1]
        )
        cx = cam.pos[0] + wux
        cy = cam.pos[1] + wuy
        reach = reach * boost.stretch(cam.vel[0], cam.vel[1])
    cell_x = jnp.floor((cx - gx0) / lam).astype(jnp.int32)
    cell_y = jnp.floor((cy - gy0) / lam).astype(jnp.int32)

    if params.splat_cells == 4:
        # nearest-corner 2x2: offsets toward the in-cell fraction's side
        fx = (cx - gx0) / lam - cell_x.astype(jnp.float32)
        fy = (cy - gy0) / lam - cell_y.astype(jnp.float32)
        sx_ = jnp.where(fx < 0.5, -1, 1)
        sy_ = jnp.where(fy < 0.5, -1, 1)
        offsets = [(0, 0), (sx_, 0), (0, sy_), (sx_, sy_)]
    else:
        offsets = [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    n_splat = len(offsets)
    # NEAREST-k retention: the sort key carries a quantized candidate->cell
    # distance in its low bits, so a bin past capacity drops the FARTHEST
    # candidates (graceful degradation at the adaptation ceiling; VERDICT r2
    # weak #5/#7 — first-k dropped arbitrary candidates).  Quantization is
    # relative to the cell edge `lam`; any monotone map works, exact
    # ordering is not required.
    inv_lam2 = jnp.float32(_DQ) / jnp.maximum(lam * lam, 1e-20)
    keys = []
    for dx, dy in offsets:
        ccx = cell_x + dx
        ccy = cell_y + dy
        in_grid = (ccx >= 0) & (ccx < wc) & (ccy >= 0) & (ccy < hc)
        lox = gx0 + ccx.astype(jnp.float32) * lam
        loy = gy0 + ccy.astype(jnp.float32) * lam
        nx_ = jnp.clip(cx, lox, lox + lam)
        ny_ = jnp.clip(cy, loy, loy + lam)
        d2 = (nx_ - cx) ** 2 + (ny_ - cy) ** 2
        use = pairs.pair_valid & in_grid & (d2 <= (reach + 1e-6) ** 2)
        dq = jnp.clip((d2 * inv_lam2).astype(jnp.int32), 0, _DQ - 1)
        keys.append(
            jnp.where(use, (ccy * wc + ccx) * _DQ + dq, n_vcells * _DQ)
        )
    key = jnp.stack(keys, axis=1).reshape(-1)  # (pcap * n_splat,)
    val = jnp.broadcast_to(
        jnp.arange(pcap, dtype=jnp.int32)[:, None], (pcap, n_splat)
    ).reshape(-1)
    min_lam = min_cell_edge(params)
    if params.camera_frame:
        from . import boost

        min_lam = min_lam * boost.stretch(cam.vel[0], cam.vel[1])
    cell_too_small = lam < min_lam
    geom = (wc_img, hc_img, pixel_size, x0, y0)
    return key, val, wc, hc, geom, cell_too_small


def _sorted_entries(
    pairs: PairData, cam, width: int, height: int, params: RenderParams
):
    """Splat entries sorted by (cell, distance-quantile) key: the entries of
    one cell are contiguous, nearest first.  Returns (scell, sval, wc, hc,
    geom, cell_too_small, entry_dropped) with scell the halo-grid cell of
    each sorted entry (wc * hc for invalid entries) and sval its pair row."""
    key, val, wc, hc, geom, cell_too_small = _splat_keys(
        pairs, cam, width, height, params
    )
    n_vcells = wc * hc
    skey, sval = jax.lax.sort_key_val(key, val)
    entry_dropped = jnp.int32(0)
    if 0 < params.entry_budget < skey.shape[0]:
        # invalid keys (= n_vcells * _DQ sentinel) sort to the END, so the
        # prefix holds every valid entry as long as their count fits the
        # budget; the binning then runs on the (much) smaller slice.
        # Overflow loses the HIGHEST-key cells (bottom image rows) —
        # entry_dropped flags it for the engine to grow the budget.
        eb = params.entry_budget
        n_valid = jnp.sum((key < n_vcells * _DQ).astype(jnp.int32))
        entry_dropped = jnp.maximum(n_valid - eb, 0)
        skey = jax.lax.slice_in_dim(skey, 0, eb, axis=0)
        sval = jax.lax.slice_in_dim(sval, 0, eb, axis=0)
    return skey // _DQ, sval, wc, hc, geom, cell_too_small, entry_dropped


def _splat_ranges(
    pairs: PairData, cam, width: int, height: int, params: RenderParams
):
    """Per-image-cell ranges of the sorted splat entries, for the fused
    pixel kernel: returns (lo, cnt, edat, bin_dropped, entry_dropped,
    cell_too_small, geom) with lo/cnt (n_img_cells,) i32 in row-major cell
    order and edat (E, 10) the pair rows in sorted-entry order.  A cell keeps
    its first bin_capacity (nearest) entries, the same candidates in the same
    order as _splat_vslot; the rest count in bin_dropped."""
    scell, sval, wc, _hc, geom, cell_too_small, entry_dropped = (
        _sorted_entries(pairs, cam, width, height, params)
    )
    wc_img, hc_img = geom[0], geom[1]
    # interior cell (r, c) is halo cell (r+1)*wc + c+1; each image row's
    # cells are consecutive halo ids, so one query per cell plus one past
    # the row end gives every [start, end) window
    rows0 = (jnp.arange(hc_img, dtype=jnp.int32) + 1) * wc + 1
    q = rows0[:, None] + jnp.arange(wc_img + 1, dtype=jnp.int32)[None, :]
    starts = jnp.searchsorted(scell, q, side="left").astype(jnp.int32)
    lo = starts[:, :-1]
    n_all = starts[:, 1:] - lo
    cnt = jnp.minimum(n_all, params.bin_capacity)
    bin_dropped = jnp.sum(n_all - cnt)
    edat = pairs.pdata[sval]
    return (lo.reshape(-1), cnt.reshape(-1), edat, bin_dropped, entry_dropped,
            cell_too_small, geom)


def _splat_vslot(
    pairs: PairData, cam, width: int, height: int, params: RenderParams
):
    """Splat compacted pairs into the (view cells + 1 halo) grid and return
    the per-cell candidate id table: (vslot (hc_img, wc_img, cap) i32 with -1
    for empty, bin_dropped, entry_dropped, cell_too_small, geometry)."""
    cap = params.bin_capacity
    scell, sval, wc, hc, geom, cell_too_small, entry_dropped = (
        _sorted_entries(pairs, cam, width, height, params)
    )
    n_vcells = wc * hc
    n_entries = scell.shape[0]
    # rank within each sorted CELL run via segmented cummax
    idx = jnp.arange(n_entries, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), scell[1:] != scell[:-1]]
    )
    run_start = jax.lax.cummax(jnp.where(is_start, idx, 0))
    rank = idx - run_start
    fits = (scell < n_vcells) & (rank < cap)
    dump = n_vcells * cap
    slot = jnp.where(fits, scell * cap + rank, dump)
    # id scatter here; _build_view_tables gathers the pair rows
    vslot = jnp.full((n_vcells * cap + 1,), -1, jnp.int32)
    vslot = vslot.at[slot].set(sval)
    vslot = vslot.at[dump].set(-1)
    bin_dropped = jnp.sum(((scell < n_vcells) & (rank >= cap)).astype(jnp.int32))

    vslot = vslot[:-1].reshape(hc, wc, cap)[1:-1, 1:-1]  # interior = image cells
    return vslot, bin_dropped, entry_dropped, cell_too_small, geom


def _build_view_tables(
    pairs: PairData, cam, width: int, height: int, params: RenderParams
):
    """XLA block-map layout: densify the splat by one row gather of pair data.
    Returns (ViewTables, bin_dropped, entry_dropped, cell_too_small, geometry)."""
    cap = params.bin_capacity
    vslot, bin_dropped, entry_dropped, cell_too_small, geom = _splat_vslot(
        pairs, cam, width, height, params
    )
    wc_img, hc_img = geom[0], geom[1]
    vok = vslot >= 0
    nf = pairs.pdata.shape[1]  # 10 (_F_* field order)
    vdat = pairs.pdata[jnp.maximum(vslot, 0)]  # (hc_img, wc_img, cap, nf)

    n_img_cells = wc_img * hc_img
    vdat = vdat.reshape(n_img_cells, cap, nf)
    vok = vok.reshape(n_img_cells, cap)
    cb = params.cells_per_block
    n_blocks = -(-n_img_cells // cb)
    pad = n_blocks * cb - n_img_cells
    vdat = jnp.pad(vdat, ((0, pad), (0, 0), (0, 0)))
    vok = jnp.pad(vok, ((0, pad), (0, 0)))
    return ViewTables(vdat=vdat, vok=vok, n_img_cells=n_img_cells), bin_dropped, entry_dropped, cell_too_small, geom


def _cell_pixel_coords(width, height, cam, params: RenderParams):
    """Pixel world coords grouped by view cell: two (n_cells_padded, k*k)
    arrays, built by index arithmetic (no gathers)."""
    k = params.cell_px
    wc_img, hc_img, pixel_size, x0, y0 = _view_grid(width, height, cam, k)
    ci = jax.lax.broadcasted_iota(jnp.int32, (hc_img * wc_img, k * k), 0)
    pj = jax.lax.broadcasted_iota(jnp.int32, (hc_img * wc_img, k * k), 1)
    cell_row = ci // wc_img
    cell_col = ci % wc_img
    sub_row = pj // k
    sub_col = pj % k
    gx = cell_col * k + sub_col  # global pixel x (may exceed width-1: pad)
    gy = cell_row * k + sub_row
    px = x0 + gx.astype(jnp.float32) * pixel_size
    py = y0 + gy.astype(jnp.float32) * pixel_size
    cb = params.cells_per_block
    n_img_cells = hc_img * wc_img
    n_blocks = -(-n_img_cells // cb)
    pad = n_blocks * cb - n_img_cells
    px = jnp.pad(px, ((0, pad), (0, 0)), constant_values=1.0e9)
    py = jnp.pad(py, ((0, pad), (0, 0)), constant_values=1.0e9)
    return px, py


def _occupancy_cells(px, py, t_e, vdat, vok, dt, rho):
    """Dense per-cell occupancy: pixels (C, k2) vs candidates (C, cap, 8).

    Returns (occupied (C, k2), winner (C, k2, cap) one-hot mask); fields of
    the winner are selected by masked reduction (_field_at)."""
    inside, dist2 = _occupancy_xy(
        px[:, :, None], py[:, :, None], t_e[:, :, None],
        vdat[:, None, :, _F_AX], vdat[:, None, :, _F_AY],
        vdat[:, None, :, _F_BX], vdat[:, None, :, _F_BY],
        vdat[:, None, :, _F_TA], dt, rho,
    )  # (C, k2, cap)
    inside = inside & vok[:, None, :]
    dist2 = jnp.where(inside, dist2, _BIG)
    min_d = jnp.min(dist2, axis=2, keepdims=True)
    occupied = min_d[:, :, 0] < _BIG
    tied = dist2 == min_d
    # first-of-ties so exactly one candidate wins
    winner = tied & (jnp.cumsum(tied.astype(jnp.int32), axis=2) == 1)
    return occupied, winner


def _field_at(vdat, winner, field):
    """Per-pixel winning candidate's field via masked reduction."""
    f = vdat[:, None, :, field]  # (C, 1, cap)
    return jnp.sum(jnp.where(winner, f, 0.0), axis=2)


def _compose_cells(
    px, py, r, occupied, winner, s_first_px, vdat, cam,
    params: RenderParams,
):
    """Shading/composition for one cell block; returns (C, 3, k2).
    All candidate fields selected by masked reduction — zero gathers."""
    vx = _field_at(vdat, winner, _F_VX)
    vy = _field_at(vdat, winner, _F_VY)
    cr = _field_at(vdat, winner, _F_CR)
    cg = _field_at(vdat, winner, _F_CG)
    cb_ = _field_at(vdat, winner, _F_CB)
    inv_r = 1.0 / jnp.maximum(r, 1e-12)
    nx = (cam.pos[0] - px) * inv_r
    ny = (cam.pos[1] - py) * inv_r
    d = doppler_factor_xy(vx, vy, nx, ny) * camera_doppler_factor_xy(
        cam.vel[0], cam.vel[1], nx, ny
    )
    sr, sg, sb = shade_channels(cr, cg, cb_, d, params)

    if params.opaque and params.retarded:
        blocked = s_first_px < (r - 2.0 * params.rho)

        def compose(shaded):
            return jnp.where(
                occupied,
                jnp.where(blocked, shaded * params.absorbed_dim, shaded),
                jnp.where(blocked, jnp.float32(params.shadow), 1.0),
            )

    else:

        def compose(shaded):
            return jnp.where(occupied, shaded, 1.0)

    return jnp.stack([compose(sr), compose(sg), compose(sb)], axis=1)


def _assemble_image(crgb, width, height, params: RenderParams, planar: bool,
                    wc_img: int, hc_img: int):
    """(n_blocks, C, 3, k2) cell colors -> (3, H, W) or (H, W, 3)."""
    k = params.cell_px
    n_img_cells = wc_img * hc_img
    flat = crgb.reshape(-1, 3, k * k)[:n_img_cells]
    img = flat.reshape(hc_img, wc_img, 3, k, k)
    img = img.transpose(2, 0, 3, 1, 4).reshape(3, hc_img * k, wc_img * k)
    img = img[:, :height, :width]
    return img if planar else img.transpose(1, 2, 0)


# ---------------------------------------------------------------------------
# Oracle renderer (exact, O(pixels * T * N) — tests / tiny scenes only)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("width", "height", "params", "pixel_chunk"))
def render_retarded_brute(
    buf: WorldlineBuffer,
    obj_index: jax.Array,  # (N,) i32 object id per particle
    objects: Objects,
    cam: Camera,
    width: int,
    height: int,
    params: RenderParams,
    pixel_chunk: int = 0,
) -> jax.Array:
    """Reference renderer: every pixel tests every (slot, particle) segment.
    Defines correct output for the accelerated path (SURVEY.md §4).
    `pixel_chunk` > 0 evaluates that many pixels at a time (the same
    result; memory bounded by chunk * T * N instead of pixels * T * N)."""
    dt, rho = params.dt, params.rho
    qax, qay, qbx, qby, ta, seg_valid = _segment_data(buf, dt)
    t_now = buf.times[buf.cursor]
    t_cap, n = qax.shape

    pc = pixel_centers(width, height, cam)
    px = pc[..., 0].reshape(-1)
    py = pc[..., 1].reshape(-1)
    if params.camera_frame:
        # boosted view: pixels are camera-frame coordinates; recover the
        # ground cone offset exactly (ops/boost.py) and evaluate everything
        # else unchanged in ground coordinates
        from . import boost

        ox, oy = boost.unwarp_xy(
            px - cam.pos[0], py - cam.pos[1], cam.vel[0], cam.vel[1]
        )
        px = cam.pos[0] + ox
        py = cam.pos[1] + oy

    fax, fay = qax.reshape(-1), qay.reshape(-1)
    fbx, fby = qbx.reshape(-1), qby.reshape(-1)
    fta = jnp.repeat(ta, n)
    valid_f = jnp.repeat(seg_valid, n) & (jnp.abs(fax) < 1e8)
    fobj = jnp.tile(obj_index, t_cap)
    fvx = buf.vel_x[:t_cap].reshape(-1)
    fvy = buf.vel_y[:t_cap].reshape(-1)

    def shade(px, py):
        relx, rely = px - cam.pos[0], py - cam.pos[1]
        r = jnp.sqrt(relx * relx + rely * rely)
        inv_r = 1.0 / jnp.maximum(r, 1e-12)
        dhx, dhy = relx * inv_r, rely * inv_r
        t_e = t_now - r if params.retarded else jnp.broadcast_to(t_now, r.shape)
        inside, dist2 = _occupancy_xy(
            px[:, None], py[:, None], t_e[:, None],
            fax[None], fay[None], fbx[None], fby[None], fta[None], dt, rho,
        )
        inside = inside & valid_f[None, :]
        dist2 = jnp.where(inside, dist2, _BIG)
        best = jnp.argmin(dist2, axis=1)
        occupied = jnp.take_along_axis(inside, best[:, None], axis=1)[:, 0]

        hit, s_hit = _ray_hit_xy(
            cam.pos[0], cam.pos[1], dhx[:, None], dhy[:, None],
            fax[None], fay[None], fbx[None], fby[None], fta[None],
            t_now, dt, rho,
        )
        s_hit = jnp.where(hit & valid_f[None, :], s_hit, _BIG)
        s_first = jnp.min(s_hit, axis=1)

        obj = fobj[best]
        cr = objects.base_color[:, 0][obj]
        cg = objects.base_color[:, 1][obj]
        cb = objects.base_color[:, 2][obj]
        nx, ny = -dhx, -dhy
        d = doppler_factor_xy(fvx[best], fvy[best], nx, ny) * (
            camera_doppler_factor_xy(cam.vel[0], cam.vel[1], nx, ny)
        )
        sr, sg, sb = shade_channels(cr, cg, cb, d, params)
        if params.opaque and params.retarded:
            blocked = s_first < (r - 2.0 * params.rho)
            comp = lambda s: jnp.where(
                occupied,
                jnp.where(blocked, s * params.absorbed_dim, s),
                jnp.where(blocked, jnp.float32(params.shadow), 1.0),
            )
        else:
            comp = lambda s: jnp.where(occupied, s, 1.0)
        return jnp.stack([comp(sr), comp(sg), comp(sb)], axis=-1)

    n_px = width * height
    if 0 < pixel_chunk < n_px:
        n_chunks = -(-n_px // pixel_chunk)
        pad = n_chunks * pixel_chunk - n_px
        chunks = (jnp.pad(px, (0, pad)).reshape(n_chunks, pixel_chunk),
                  jnp.pad(py, (0, pad)).reshape(n_chunks, pixel_chunk))
        img = jax.lax.map(lambda a: shade(*a), chunks).reshape(-1, 3)[:n_px]
    else:
        img = shade(px, py)
    return img.reshape(height, width, 3)


# ---------------------------------------------------------------------------
# Accelerated renderer
# ---------------------------------------------------------------------------


def _instant_pairs(buf, obj_index, objects, params: RenderParams):
    """Pairs for the instantaneous view: only the newest segment (age 1 ->
    age 0), i.e. "measured reality" — the filled upgrade of the reference's
    debug point renderer (points_norel.glsl)."""
    t_cap = buf.capacity
    n = buf.num_particles

    def col(plane, age):
        c = buf.cursor + t_cap - age
        return jax.lax.dynamic_slice(plane, (c, 0), (1, n))[0]

    qax, qay = col(buf.pos_x, 1), col(buf.pos_y, 1)
    qbx, qby = col(buf.pos_x, 0), col(buf.pos_y, 0)
    pvx, pvy = col(buf.vel_x, 1), col(buf.vel_y, 1)
    pta = buf.times[buf.cursor] - params.dt
    valid = (jnp.abs(qax) < 1.0e8) & (buf.frames_in_use >= 2)
    far = 2.0e9
    keep = lambda v: jnp.where(valid, v, far)
    colr = lambda c: objects.base_color[:, c][obj_index]
    pdata = jnp.stack(
        [
            keep(qax), keep(qay), keep(qbx), keep(qby),
            jnp.broadcast_to(pta, (n,)),
            pvx, pvy, colr(0), colr(1), colr(2),
        ],
        axis=-1,
    )
    return PairData(
        pdata=pdata, pair_valid=valid, n_pairs=jnp.sum(valid.astype(jnp.int32))
    )


def _retina(pairs: PairData, cam, t_now, params: RenderParams):
    """First hit per angle over ALL pairs (dense chunked broadcast);
    returns s_first (num_rays,) packed also as (num_rays, 8) rows for
    row-gather lookups."""
    dt, rho = params.dt, params.rho
    pcap = pairs.pdata.shape[0]
    n_rays = params.num_rays
    theta = -_PI + (jnp.arange(n_rays, dtype=jnp.float32) + 0.5) * (2 * _PI / n_rays)
    dhx = jnp.cos(theta)
    dhy = jnp.sin(theta)
    chunk = min(params.ray_chunk, pcap)
    n_chunks = -(-pcap // chunk)
    pad = n_chunks * chunk - pcap
    pd = pairs.pdata

    def col(i):
        return jnp.pad(pd[:, i], (0, pad)).reshape(n_chunks, chunk)

    cok = jnp.pad(pairs.pair_valid, (0, pad)).reshape(n_chunks, chunk)

    def ray_chunk_step(s_min, args):
        ax, ay, bx, by, t_, ok = args
        hit, s_hit = _ray_hit_xy(
            cam.pos[0], cam.pos[1], dhx[:, None], dhy[:, None],
            ax[None], ay[None], bx[None], by[None], t_[None],
            t_now, dt, rho,
        )
        s_hit = jnp.where(hit & ok[None, :], s_hit, _BIG)
        return jnp.minimum(s_min, jnp.min(s_hit, axis=1)), None

    # static trip count: a scan over the static budget, not a loop bounded
    # by the traced pair count
    s_first, _ = jax.lax.scan(
        ray_chunk_step, jnp.full((n_rays,), _BIG),
        (col(_F_AX), col(_F_AY), col(_F_BX), col(_F_BY), col(_F_TA), cok),
    )
    return s_first


def render_retina(
    buf: WorldlineBuffer,
    obj_index: jax.Array,
    objects: Objects,
    cam: Camera,
    params: RenderParams,
    height: int = 64,
    planar: bool = False,
):
    """The observer's ACTUAL field of view: a 360-degree 1D retina strip.

    Unlike the map view (which shows retarded state at map positions), this
    is what a point camera physically sees: one color per CAMERA-FRAME
    arrival angle, with relativistic ABERRATION mapping camera-frame angles
    to ground-frame look directions — a moving observer sees the forward
    view angularly compressed (headlight effect) and Doppler boosted
    (BASELINE config 4).  Returns an (height, num_rays, 3) strip (the 1D
    retina repeated vertically for display).
    """
    return _render_retina_impl(buf, obj_index, objects, cam, params, height, planar)


@partial(jax.jit, static_argnames=("params", "height", "planar"))
def _render_retina_impl(buf, obj_index, objects, cam, params, height, planar):
    dt, rho = params.dt, params.rho
    t_now = buf.times[buf.cursor]
    n_rays = params.num_rays
    # camera-frame arrival angles -> ground-frame look directions (aberration)
    theta = -_PI + (jnp.arange(n_rays, dtype=jnp.float32) + 0.5) * (2 * _PI / n_rays)
    # photon arrives along -d_cam in the camera frame; compose with camera
    # velocity to get its ground-frame propagation, then look along -that.
    acx = -jnp.cos(theta)
    acy = -jnp.sin(theta)
    cvx, cvy = cam.vel[0], cam.vel[1]
    # velocity addition (componentized, c=1): u' = ((u.v_hat + v) v_hat + u_perp/gamma) / (1 + u.v)
    v2 = cvx * cvx + cvy * cvy
    safe_v2 = jnp.maximum(v2, 1e-12)
    udotv = acx * cvx + acy * cvy
    parx = udotv / safe_v2 * cvx
    pary = udotv / safe_v2 * cvy
    g = _gamma_xy(cvx, cvy)
    denom = 1.0 + udotv
    px_ = jnp.where(v2 > 1e-12, (parx + cvx + (acx - parx) / g) / denom, acx)
    py_ = jnp.where(v2 > 1e-12, (pary + cvy + (acy - pary) / g) / denom, acy)
    inv = 1.0 / jnp.maximum(jnp.sqrt(px_ * px_ + py_ * py_), 1e-12)
    dhx = -px_ * inv  # ground-frame look direction
    dhy = -py_ * inv

    # candidates: cone band search over the full plane (a panorama sees all
    # directions, so no view-rect culling)
    pairs = _band_pairs_nocull(buf, obj_index, objects, cam, t_now, params)

    # march all pairs, tracking the winning pair's shading fields
    pcap = pairs.pdata.shape[0]
    chunk = min(params.ray_chunk, pcap)
    n_chunks = -(-pcap // chunk)
    pad = n_chunks * chunk - pcap
    pd = pairs.pdata

    def col(i):
        return jnp.pad(pd[:, i], (0, pad)).reshape(n_chunks, chunk)

    cok = jnp.pad(pairs.pair_valid, (0, pad)).reshape(n_chunks, chunk)

    def step(carry, args):
        s_min, wvx, wvy, wcr, wcg, wcb = carry
        ax, ay, bx, by, t_, vx, vy, cr, cg, cb, ok = args
        hit, s_hit = _ray_hit_xy(
            cam.pos[0], cam.pos[1], dhx[:, None], dhy[:, None],
            ax[None], ay[None], bx[None], by[None], t_[None], t_now, dt, rho,
        )
        s_hit = jnp.where(hit & ok[None, :], s_hit, _BIG)
        s_c = jnp.min(s_hit, axis=1)
        win = (s_hit == s_c[:, None]) & (s_c[:, None] < _BIG)
        first = win & (jnp.cumsum(win.astype(jnp.int32), axis=1) == 1)
        pick = lambda f: jnp.sum(jnp.where(first, f[None, :], 0.0), axis=1)
        better = s_c < s_min
        return (
            jnp.where(better, s_c, s_min),
            jnp.where(better, pick(vx), wvx),
            jnp.where(better, pick(vy), wvy),
            jnp.where(better, pick(cr), wcr),
            jnp.where(better, pick(cg), wcg),
            jnp.where(better, pick(cb), wcb),
        ), None

    init = tuple(jnp.full((n_rays,), v, jnp.float32) for v in (_BIG, 0, 0, 0, 0, 0))
    (s_first, vx, vy, cr, cg, cb), _ = jax.lax.scan(
        step, init,
        (col(_F_AX), col(_F_AY), col(_F_BX), col(_F_BY), col(_F_TA),
         col(_F_VX), col(_F_VY), col(_F_CR), col(_F_CG), col(_F_CB), cok),
    )
    hit_any = s_first < _BIG
    nx, ny = -dhx, -dhy  # photon propagation: event -> camera (ground frame)
    d = doppler_factor_xy(vx, vy, nx, ny) * camera_doppler_factor_xy(
        cvx, cvy, nx, ny
    )
    sr, sg, sb = shade_channels(cr, cg, cb, d, params)
    comp = lambda c: jnp.where(hit_any, c, 1.0)
    strip = jnp.stack([comp(sr), comp(sg), comp(sb)], axis=0)  # (3, R)
    img = jnp.broadcast_to(strip[:, None, :], (3, height, n_rays))
    return img if planar else img.transpose(1, 2, 0)


def _band_pairs_nocull(buf, obj_index, objects, cam, t_now, params):
    """Band pairs without view-rect culling (retina sees all directions)."""
    dt, rho, band = params.dt, params.rho, params.band
    n = buf.num_particles
    cxm, cym = cam.pos[0], cam.pos[1]
    route = _euclid_route(cxm, cym)
    _a0, hi0, _trunc, (wx, wy, wvx, wvy, ages) = _cone_band_window(
        buf, None, params, cam=cam
    )
    qax, qay = wx[:, :band], wy[:, :band]
    qbx, qby = wx[:, 1:], wy[:, 1:]
    pvx, pvy = wvx[:, :band], wvy[:, :band]
    age_a = ages[:, :band]
    pta = t_now - age_a.astype(jnp.float32) * dt
    ra, rb = route(qax, qay), route(qbx, qby)
    s_hi = t_now - pta
    valid = (
        (age_a >= 1) & (age_a <= hi0)
        & (jnp.maximum(ra, rb) >= s_hi - dt - rho)
        & (jnp.minimum(ra, rb) <= s_hi + rho)
        & (jnp.abs(qax) < 1.0e8)
    )
    far = 2.0e9
    keep = lambda v: jnp.where(valid, v, far).reshape(-1)
    colr = lambda c: jnp.broadcast_to(
        objects.base_color[:, c][obj_index][:, None], (n, band)
    ).reshape(-1)
    pdata = jnp.stack(
        [keep(qax), keep(qay), keep(qbx), keep(qby),
         jnp.where(valid, pta, 0.0).reshape(-1),
         pvx.reshape(-1), pvy.reshape(-1), colr(0), colr(1), colr(2)],
        axis=-1,
    )
    return PairData(
        pdata=pdata, pair_valid=valid.reshape(-1),
        n_pairs=jnp.sum(valid.astype(jnp.int32)),
    )


def _occlusion_ds(params: RenderParams) -> int:
    ds = max(1, params.occlusion_downsample)
    return ds if params.cell_px % ds == 0 else 1


def _sfirst_lookup(s_first, gxq, gyq, x0, y0, pixel_size, cam, n_rays, off,
                   camera_frame: bool = False):
    """Retina value at the pixel/quad-center angles given by integer pixel
    coords (gxq, gyq) + half-quad offset `off`.

    `camera_frame`: pixel coords are boosted-view coords; the retina bins by
    GROUND bearing, so unwarp to the ground cone offset first (ops/boost.py).
    """
    pxw = x0 + (gxq.astype(jnp.float32) + off) * pixel_size
    pyw = y0 + (gyq.astype(jnp.float32) + off) * pixel_size
    ox = pxw - cam.pos[0]
    oy = pyw - cam.pos[1]
    if camera_frame:
        from . import boost

        ox, oy = boost.unwarp_xy(ox, oy, cam.vel[0], cam.vel[1])
    phi = jnp.arctan2(oy, ox)
    ri = jnp.clip(
        jnp.floor((phi + _PI) / (2 * _PI) * n_rays).astype(jnp.int32),
        0, n_rays - 1,
    )
    return s_first[ri]


def _retina_plane(s_first, n_rows: int, width: int, height: int, cam,
                  params: RenderParams):
    """Retina first-hit distance for every pixel of the first `n_rows` view
    cells, as an (n_rows, k*k) plane in cell-major pixel order (one lookup
    per occlusion_downsample quad, broadcast to its pixels)."""
    k = params.cell_px
    ds = _occlusion_ds(params)
    kq = k // ds
    wc, _hc, ps_, x0_, y0_ = _view_grid(width, height, cam, k)
    ci = jax.lax.broadcasted_iota(jnp.int32, (n_rows, kq * kq), 0)
    pj = jax.lax.broadcasted_iota(jnp.int32, (n_rows, kq * kq), 1)
    gx = (ci % wc) * k + (pj % kq) * ds
    gy = (ci // wc) * k + (pj // kq) * ds
    sfq = _sfirst_lookup(
        s_first, gx, gy, x0_, y0_, ps_, cam, params.num_rays, (ds - 1) * 0.5,
        camera_frame=params.camera_frame,
    )
    if ds > 1:
        sfq = sfq.reshape(n_rows, kq, 1, kq, 1)
        sfq = jnp.broadcast_to(
            sfq, (n_rows, kq, ds, kq, ds)
        ).reshape(n_rows, k * k)
    return sfq


def _pixel_pass_triton_path(
    pairs: PairData, rpairs: PairData, cam, t_now, width: int, height: int,
    params: RenderParams, use_rays: bool, planar: bool,
):
    """Fused pixel pass (ops/pixel_triton.py) over per-cell ranges of the
    sorted splat entries.  Returns (image, bin_dropped, entry_dropped,
    cell_too_small)."""
    from . import pixel_triton

    lo, cnt, edat, bin_dropped, entry_dropped, cell_too_small, geom = (
        _splat_ranges(pairs, cam, width, height, params)
    )
    wc_img, hc_img, pixel_size, x0, y0 = geom
    k = params.cell_px
    n_cells = wc_img * hc_img
    npx = pixel_triton.pixel_block(k)
    if use_rays:
        s_first = _retina(rpairs, cam, t_now, params)
        sfpx = _retina_plane(s_first, n_cells, width, height, cam, params)
        sfpx = jnp.pad(sfpx, ((0, 0), (0, npx - k * k)))
    else:
        sfpx = jnp.zeros((n_cells, npx), jnp.float32)
    scal = jnp.stack(
        [t_now, cam.pos[0], cam.pos[1], cam.vel[0], cam.vel[1], x0, y0,
         pixel_size]
    ).astype(jnp.float32)
    img = pixel_triton.pixel_pass(
        scal, lo, cnt, edat, sfpx, k=k, wc_img=wc_img, width=width,
        height=height, planar=planar, use_rays=use_rays, params=params,
        interpret=params.triton_interpret,
    )
    return img, bin_dropped, entry_dropped, cell_too_small


def _render_retarded_impl(
    buf: WorldlineBuffer,
    obj_index: jax.Array,
    objects: Objects,
    cam: Camera,
    width: int,
    height: int,
    params: RenderParams,
    planar: bool,
    boundary=None,
):
    dt, rho = params.dt, params.rho
    t_now = buf.times[buf.cursor]
    use_rays = params.opaque and params.retarded
    if params.camera_frame and not params.retarded:
        raise ValueError(
            "camera_frame requires retarded=True (the boosted view is a warp"
            " of the past light cone; an instantaneous boosted view would"
            " need a per-event simultaneity re-slice)"
        )

    retina_dropped = None
    segment_dropped = None
    if params.retarded:
        pairs_raw, band_truncated, segment_dropped = _band_pairs(
            buf, obj_index, objects, cam, t_now, width, height, params,
            # the view-hull cull reasons in ground coordinates; the boosted
            # view's ground footprint extends past the output rect (like the
            # curved routes), so disable it there
            cull_hull=not params.camera_frame,
        )
        if (
            use_rays
            and boundary is not None
            and 0 < params.retina_budget < pairs_raw.pdata.shape[0]
        ):
            # (when the raw layout already fits the budget, fall through to
            # the plain path: the two-segment sort+gather over (N*band) rows
            # would cost more than the retina march it trims)
            # boundary pairs compacted to the buffer FRONT; the occlusion
            # retina is then a static prefix slice of the same buffer
            # pdata rows per particle: `segments` when rank compaction is on
            k_rows = (
                params.segments
                if 0 < params.segments < params.band
                else params.band
            )
            rmask = jnp.repeat(boundary, k_rows)
            pairs, n_b = _compact_pairs_two_segment(
                pairs_raw, rmask, params.pair_budget
            )
            rb = min(params.retina_budget, pairs.pdata.shape[0])
            rpairs = PairData(
                pdata=jax.lax.slice_in_dim(pairs.pdata, 0, rb, axis=0),
                pair_valid=pairs.pair_valid[:rb]
                & (jnp.arange(rb) < jnp.minimum(n_b, rb)),
                n_pairs=jnp.minimum(n_b, rb),
            )
            retina_dropped = jnp.maximum(n_b - rb, 0)
        else:
            pairs = _compact_pairs_to_budget(pairs_raw, params.pair_budget)
            rpairs = pairs
    else:
        pairs = _instant_pairs(buf, obj_index, objects, params)
        rpairs = pairs
        band_truncated = jnp.int32(0)

    if paths.pixel_path(params.backend) == "triton":
        img, bin_dropped, entry_dropped, cell_too_small = (
            _pixel_pass_triton_path(
                pairs, rpairs, cam, t_now, width, height, params, use_rays,
                planar,
            )
        )
        diag = RenderDiag(
            pairs_used=pairs.n_pairs,
            band_truncated=band_truncated,
            bin_dropped=bin_dropped,
            cell_too_small=cell_too_small,
            retina_dropped=retina_dropped,
            entry_dropped=entry_dropped,
            segment_dropped=segment_dropped,
        )
        return img, diag

    tables, bin_dropped, entry_dropped, cell_too_small, geom = _build_view_tables(
        pairs, cam, width, height, params
    )
    wc_img, hc_img, _ps, _x0, _y0 = geom

    pxs, pys = _cell_pixel_coords(width, height, cam, params)
    cb = params.cells_per_block
    n_blocks = pxs.shape[0] // cb
    cxm, cym = cam.pos[0], cam.pos[1]
    if params.camera_frame:
        # pixels address boosted-view coordinates; every downstream test
        # (occupancy, cone radius, shading direction) runs on the GROUND
        # query point, recovered by the closed-form inverse warp
        from . import boost

        gqx, gqy = boost.unwarp_xy(pxs - cxm, pys - cym, cam.vel[0], cam.vel[1])
        pxs, pys = cxm + gqx, cym + gqy

    if use_rays:
        s_first = _retina(rpairs, cam, t_now, params)
        s_first_px_all = _retina_plane(
            s_first, pxs.shape[0], width, height, cam, params
        )
    else:
        s_first_px_all = jnp.full_like(pxs, _BIG)

    def block_fn(args):
        vdat, vok, px, py, s_first_px = args
        relx = px - cxm
        rely = py - cym
        r = jnp.sqrt(relx * relx + rely * rely)
        t_e = t_now - r if params.retarded else jnp.broadcast_to(t_now, r.shape)
        occupied, best = _occupancy_cells(px, py, t_e, vdat, vok, dt, rho)
        return _compose_cells(
            px, py, r, occupied, best, s_first_px, vdat, cam, params
        )

    args = (
        tables.vdat.reshape(n_blocks, cb, *tables.vdat.shape[1:]),
        tables.vok.reshape(n_blocks, cb, *tables.vok.shape[1:]),
        pxs.reshape(n_blocks, cb, -1),
        pys.reshape(n_blocks, cb, -1),
        s_first_px_all.reshape(n_blocks, cb, -1),
    )
    if n_blocks <= 1:
        crgb = block_fn(jax.tree.map(lambda a: a[0], args))[None]
    else:
        crgb = jax.lax.map(block_fn, args)  # (n_blocks, cb, 3, k2)
    img = _assemble_image(
        crgb, width, height, params, planar, wc_img, hc_img
    )
    diag = RenderDiag(
        pairs_used=pairs.n_pairs,
        band_truncated=band_truncated,
        bin_dropped=bin_dropped,
        cell_too_small=cell_too_small,
        retina_dropped=retina_dropped,
        entry_dropped=entry_dropped,
        segment_dropped=segment_dropped,
    )
    return img, diag


@partial(jax.jit, static_argnames=("width", "height", "params", "planar"))
def render_retarded(
    buf: WorldlineBuffer,
    obj_index: jax.Array,
    objects: Objects,
    cam: Camera,
    width: int,
    height: int,
    params: RenderParams,
    planar: bool = False,
    boundary=None,
) -> jax.Array:
    """`boundary` ((N,) bool, e.g. worldline.boundary_mask) enables the
    boundary-only occlusion retina when params.retina_budget > 0."""
    img, _ = _render_retarded_impl(
        buf, obj_index, objects, cam, width, height, params, planar,
        boundary=boundary,
    )
    return img


@partial(jax.jit, static_argnames=("width", "height", "params", "planar"))
def render_views(
    buf: WorldlineBuffer,
    obj_index: jax.Array,
    objects: Objects,
    cams: Camera,  # batched Camera pytree — leaves carry a leading B axis
    width: int,
    height: int,
    params: RenderParams,
    planar: bool = False,
    boundary=None,
) -> jax.Array:
    """Multi-observer batch: B cameras over ONE stored worldline ring in a
    single traced program, returning (B, H, W, 3) (or (B, 3, H, W) planar).

    The body (band search → binning → pixel pass) is traced once by
    `lax.map`; per-view work stays device-resident, so a B-view batch pays
    one dispatch and shares the ring/boundary operands — the serving path
    for rendering many observers (or a camera sweep over a finished
    simulation) from one stored history.  Build `cams` with
    `camera.stack_cameras`.  The reference has no multi-view counterpart
    (one window, one camera: /root/reference/src/main.rs:179-352)."""
    def one(cam):
        return render_retarded(
            buf, obj_index, objects, cam, width, height, params, planar,
            boundary=boundary,
        )

    return jax.lax.map(one, cams)


@partial(jax.jit, static_argnames=("width", "height", "params", "planar"))
def render_retarded_with_diag(
    buf: WorldlineBuffer,
    obj_index: jax.Array,
    objects: Objects,
    cam: Camera,
    width: int,
    height: int,
    params: RenderParams,
    planar: bool = False,
    boundary=None,
):
    return _render_retarded_impl(
        buf, obj_index, objects, cam, width, height, params, planar,
        boundary=boundary,
    )
