"""Fused retarded-time pixel pass as a Pallas kernel on the Triton route.

The XLA pixel pass (raytrace._render_retarded_impl) densifies every view
cell's candidates into a (cells, cap, 10) table and evaluates occupancy as
(cells, k*k, cap) broadcasts, so each intermediate of the candidate test goes
through device memory.  Here one program owns one view cell (a k x k pixel
block, padded to a power of two of pixels): it reads its own [lo, lo + n)
range of the SORTED splat entries (raytrace._splat_ranges), keeps a running
per-pixel min over those candidates in registers, then shades and composites
and writes its pixels straight into the image.

Semantics mirror the XLA path exactly: the same candidates in the same
(cell, distance-quantile) order, the same in-time window, strict `<` against
a running min that starts one f32 ULP past rho^2 (so `dist2 <= rho^2` is
accepted and the FIRST minimum in sorted order wins, like the XLA path's
first-of-ties one-hot), and the shading formulas are the shared ones from
raytrace.  The occlusion retina arrives as a per-pixel plane computed by XLA.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import raytrace as rt

# warps per program; one program shades one view cell (256 pixels at the
# ladder's cell_px=16), chosen on an H100 (PERF.md, pixel-pass finding)
NUM_WARPS = 4


def _pixel_kernel(scal_ref, lo_ref, cnt_ref, edat_ref, sf_ref, out_ref, *,
                  k: int, npx: int, wc_img: int, width: int, height: int,
                  planar: bool, use_rays: bool, params):
    c = pl.program_id(0)
    t_now = scal_ref[0]
    cxm, cym = scal_ref[1], scal_ref[2]
    cvx, cvy = scal_ref[3], scal_ref[4]
    x0, y0, pixel_size = scal_ref[5], scal_ref[6], scal_ref[7]

    p = jax.lax.broadcasted_iota(jnp.int32, (npx,), 0)
    cy = jax.lax.div(c, jnp.int32(wc_img))
    cx = c - cy * wc_img
    gx = cx * k + jax.lax.rem(p, jnp.int32(k))
    gy = cy * k + jax.lax.div(p, jnp.int32(k))
    live = (p < k * k) & (gx < width) & (gy < height)
    px = x0 + gx.astype(jnp.float32) * pixel_size
    py = y0 + gy.astype(jnp.float32) * pixel_size
    if params.camera_frame:
        from . import boost

        ox, oy = boost.unwarp_xy(px - cxm, py - cym, cvx, cvy)
        px, py = cxm + ox, cym + oy
    relx = px - cxm
    rely = py - cym
    r = jnp.sqrt(relx * relx + rely * rely)
    t_e = t_now - r if params.retarded else jnp.broadcast_to(t_now, r.shape)

    dt, rho = params.dt, params.rho
    rho2_edge = float(np.nextafter(np.float32(rho * rho), np.float32(np.inf)))
    lo = lo_ref[c]

    def body(j, carry):
        min_d, wvx, wvy, wcr, wcg, wcb = carry
        e = lo + j
        f = lambda i: edat_ref[e, i]
        ax, ay, bx, by = f(rt._F_AX), f(rt._F_AY), f(rt._F_BX), f(rt._F_BY)
        tau = (t_e - f(rt._F_TA)) / dt
        in_time = (tau >= -0.001) & (tau <= 1.001)
        tau_c = jnp.clip(tau, 0.0, 1.0)
        dx = px - (ax + tau_c * (bx - ax))
        dy = py - (ay + tau_c * (by - ay))
        dist2 = dx * dx + dy * dy
        better = in_time & (dist2 < min_d)
        return (
            jnp.where(better, dist2, min_d),
            jnp.where(better, f(rt._F_VX), wvx),
            jnp.where(better, f(rt._F_VY), wvy),
            jnp.where(better, f(rt._F_CR), wcr),
            jnp.where(better, f(rt._F_CG), wcg),
            jnp.where(better, f(rt._F_CB), wcb),
        )

    zero = jnp.zeros((npx,), jnp.float32)
    min_d, vx, vy, cr, cg, cb = jax.lax.fori_loop(
        0, cnt_ref[c], body,
        (jnp.full((npx,), rho2_edge, jnp.float32),
         zero, zero, zero, zero, zero),
    )
    occupied = min_d < rho2_edge

    inv_r = 1.0 / jnp.maximum(r, 1e-12)
    nx = (cxm - px) * inv_r
    ny = (cym - py) * inv_r
    d = rt.doppler_factor_xy(vx, vy, nx, ny) * rt.camera_doppler_factor_xy(
        cvx, cvy, nx, ny
    )
    sr, sg, sb = rt.shade_channels(cr, cg, cb, d, params)
    if use_rays:
        blocked = sf_ref[...] < (r - 2.0 * rho)

        def compose(s):
            return jnp.where(
                occupied,
                jnp.where(blocked, s * params.absorbed_dim, s),
                jnp.where(blocked, jnp.float32(params.shadow), 1.0),
            )
    else:

        def compose(s):
            return jnp.where(occupied, s, 1.0)

    pix = gy * width + gx
    for ch, s in enumerate((sr, sg, sb)):
        idx = ch * (width * height) + pix if planar else pix * 3 + ch
        plgpu.store(out_ref.at[idx], compose(s), mask=live)


def pixel_block(k: int) -> int:
    """Pixels per program: k*k rounded up to a power of two (Triton blocks
    are powers of two; the extra lanes are masked)."""
    return 1 << (k * k - 1).bit_length()


@functools.partial(
    jax.jit,
    static_argnames=("k", "wc_img", "width", "height", "planar", "use_rays",
                     "params", "interpret"),
)
def pixel_pass(scal, lo, cnt, edat, sfpx, *, k: int, wc_img: int, width: int,
               height: int, planar: bool, use_rays: bool, params,
               interpret: bool = False):
    """Shade every view cell.

    scal (8,) f32: t_now, cam x, cam y, cam vx, cam vy, x0, y0, pixel size.
    lo, cnt (n_cells,) i32: each cell's first sorted entry and entry count.
    edat (E, 10) f32: pair rows in sorted-entry order (raytrace._F_* fields).
    sfpx (n_cells, pixel_block(k)) f32: retina first-hit distance per pixel
    (read only when `use_rays`).
    Returns the (3, H, W) image when `planar`, else (H, W, 3)."""
    n_cells = lo.shape[0]
    npx = pixel_block(k)
    kernel = functools.partial(
        _pixel_kernel, k=k, npx=npx, wc_img=wc_img, width=width,
        height=height, planar=planar, use_rays=use_rays, params=params,
    )
    whole = pl.BlockSpec()
    out = pl.pallas_call(
        kernel,
        grid=(n_cells,),
        in_specs=[whole, whole, whole, whole,
                  pl.BlockSpec((None, npx), lambda c: (c, 0))],
        out_specs=whole,
        out_shape=jax.ShapeDtypeStruct((3 * height * width,), jnp.float32),
        backend="triton",
        interpret=interpret,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        name="pixel_pass",
    )(scal, lo, cnt, edat, sfpx)
    return out.reshape((3, height, width) if planar else (height, width, 3))
