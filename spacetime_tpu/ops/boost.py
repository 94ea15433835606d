"""Closed-form image warp for the camera-frame (boosted) map view.

The default map view plots every past-light-cone event at its GROUND-frame
position.  The reference's archived observer-frame design (`Perspective` /
`view_from_observer`, reference: src/twoplusone/object_archive.txt:20-99)
wanted the complementary picture: the scene as laid out in the *moving
camera's* instantaneous rest frame.  This module provides it exactly.

Let the camera be at ground position x_c, ground time t_now, velocity v
(|v| < 1, c = 1).  Every rendered event E sits on the camera's past light
cone: with dx = x_E - x_c and dt = t_E - t_now, the cone condition is
dt = -|dx|.  Boosting E into the camera's instantaneous rest frame S'
(standard Lorentz transform with velocity v) gives spatial coordinates

    u_par  = gamma * (dx_par + v * |dx|)        (component along v-hat)
    u_perp = dx_perp                            (transverse unchanged)

— the past cone is Lorentz-invariant (dt' = -|u|), so the boosted view is a
pure, closed-form, invertible WARP of the ground retarded map.  Physics
checks embedded in the forward map: a static source directly ahead at ground
distance d images at gamma*(1+v)*d (approaching objects appear farther —
the classical retarded-position result), one directly behind at
gamma*(1-v)*d.

The inverse (pixel u -> ground offset dx) is also closed form.  Writing
a = u_par / gamma and uperp2 = |u|^2 - u_par^2, the cone radius r = |dx|
solves r^2/gamma^2 + 2*a*v*r - (a^2 + uperp2) = 0, whose positive root is

    r = gamma^2 * (sqrt(a^2 * v^2 + (a^2 + uperp2) / gamma^2) - a * v)

and then dx_par = a - v * r, dx_perp = u_perp.

The warp's Jacobian has maximum singular value gamma*(1+|v|) (attained
radially ahead of the motion), used to scale splat reach conservatively in
ops/raytrace._splat_keys.

Everything is componentized scalar-plane math and
safe to call inside Pallas kernels (pure jnp, no gathers).
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12


def _vhat(vx, vy):
    v = jnp.sqrt(vx * vx + vy * vy)
    inv = 1.0 / jnp.maximum(v, _EPS)
    return v, vx * inv, vy * inv


def gamma_of(vx, vy):
    v2 = vx * vx + vy * vy
    return 1.0 / jnp.sqrt(jnp.maximum(1.0 - v2, _EPS))


def stretch(vx, vy):
    """Max Jacobian singular value of warp_xy: gamma * (1 + |v|)."""
    v = jnp.sqrt(vx * vx + vy * vy)
    return gamma_of(vx, vy) * (1.0 + v)


def warp_xy(dx, dy, vx, vy):
    """Ground cone offset (dx, dy) -> camera-frame plot offset (ux, uy)."""
    v, vhx, vhy = _vhat(vx, vy)
    g = gamma_of(vx, vy)
    d_par = dx * vhx + dy * vhy
    r = jnp.sqrt(dx * dx + dy * dy)
    # u = dx + v-hat * ((gamma - 1) * d_par + gamma * v * r)
    bump = (g - 1.0) * d_par + g * v * r
    ux = dx + vhx * bump
    uy = dy + vhy * bump
    still = v < 1e-9
    return jnp.where(still, dx, ux), jnp.where(still, dy, uy)


def unwarp_xy(ux, uy, vx, vy):
    """Camera-frame plot offset (ux, uy) -> ground cone offset (dx, dy)."""
    v, vhx, vhy = _vhat(vx, vy)
    g = gamma_of(vx, vy)
    u_par = ux * vhx + uy * vhy
    u2 = ux * ux + uy * uy
    uperp2 = jnp.maximum(u2 - u_par * u_par, 0.0)
    a = u_par / g
    inv_g2 = jnp.maximum(1.0 - v * v, _EPS)  # 1/gamma^2, exact
    s = jnp.sqrt(a * a * v * v + (a * a + uperp2) * inv_g2)
    r = (s - a * v) / inv_g2
    d_par = a - v * r
    dx = ux + vhx * (d_par - u_par)
    dy = uy + vhy * (d_par - u_par)
    still = v < 1e-9
    return jnp.where(still, ux, dx), jnp.where(still, uy, dy)
