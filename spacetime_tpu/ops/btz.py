"""BTZ black hole (2+1 AdS) retarded-time rendering — closed-form null
geodesics.

BASELINE config 5 names "conical-defect/BTZ mass" as the stretch goal; the
conical defect is ops/curved.py.  This module adds the genuinely curved case:
the non-rotating BTZ black hole

    ds^2 = -f(r) dt^2 + dr^2/f(r) + r^2 dphi^2,   f(r) = r^2/l^2 - M,

with horizon r_h = l sqrt(M).  Everything needed for retarded rendering is
closed form (no numerical ray marching):

  * ORBITS.  With u = 1/r the null orbit equation is
    (du/dphi)^2 = b^2 + M u^2 (b^2 = E^2/L^2 - 1/l^2), a linear ODE whose
    solutions are u(phi) = A e^{mu phi} + B e^{-mu phi}, mu = sqrt(M).  The
    boundary problem (u_a at 0, u_b at dphi) is a 2x2 linear solve; convexity
    (u'' = M u > 0) keeps every connecting orbit outside the horizon
    whenever its endpoints are, so existence is unconditional.
  * TRAVEL TIME.  dt/dphi = (E/L) l^2 / (1 - M l^2 u^2) integrates in closed
    form: with w = e^{2 mu phi} the integrand is rational and

        t = l/(2 sqrt(M)) * [ ln((w - w-)/(w - w+)) ]_{w=1}^{w=e^{2 mu dphi}}

    where w± are the roots of M l^2 A^2 w^2 - (1 - 2ABMl^2) w + M l^2 B^2
    (the analytic continuation's horizon touchpoints, always outside the
    integration range).  (E/L)^2 = 1/l^2 - 4ABM is positive for every
    exterior-connecting orbit.
  * ROUTES.  As on the cone, two direct routes per pixel: angular
    separations |dphi| and 2 pi - |dphi|.  With params.btz_reflections,
    two MORE routes reflect once off the AdS conformal boundary (reached
    in finite coordinate time; Dirichlet wall, the standard AdS boundary
    condition): since u'' = M u is linear and odd in u, the reflected
    connecting orbit is the analytic continuation with the emitter
    endpoint NEGATED in u — same 2x2 solve, same closed-form delay/drag
    integrals (every integrand is even in u; _null_delay_u).  With
    params.btz_windings = k, every route family repeats with separations
    + 2 pi, ..., + 2 pi k: orbits circling the hole extra times — the 2+1
    analog of higher-order photon-ring images (same closed forms;
    existence is unconditional at every winding, _orbit_setup docstring).
    Multi-bounce routes are PROVABLY absent: the continued orbit has at
    most one zero, so a photon leaving the boundary falls monotonically
    inward and never returns (_orbit_setup docstring).

Modeling limitations (documented):
  * Opaque occlusion runs along the CURVED routes via a 1D retina over the
    closed-form arrival bearings (validated against a geodesic-walking
    oracle); Doppler shading uses the exact ray direction at EACH end of
    the bent route (emitter-side tangent for the source term, camera-side
    for the observer term).
  * Rendering uses coordinate time t (the static observer at the camera has
    d tau = sqrt(f) dt; a global shift does not change images).
  * Softbody physics runs in the flat chart: keep bodies at r >> r_h where
    the optical metric is slowly varying (also required by the band search's
    monotonicity — the delay gradient diverges at the horizon).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..camera import Camera
from ..state import Objects
from .raytrace import (
    PairData,
    RenderDiag,
    RenderParams,
    _BIG,
    _PI,
    _assemble_image,
    _band_pairs,
    _build_view_tables,
    _cell_pixel_coords,
    _occupancy_cells,
    _field_at,
    _F_AX, _F_AY, _F_BX, _F_BY, _F_TA,
    _F_VX, _F_VY, _F_CR, _F_CG, _F_CB,
    camera_doppler_factor_xy,
    doppler_factor_xy,
    shade_channels,
)
from .worldline import WorldlineBuffer

_EPS = 1e-12


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BTZBlackHole:
    center: jax.Array  # (2,) chart position of the hole
    mass: jax.Array  # () M > 0 (horizon r_h = l sqrt(M))
    ads_l: jax.Array  # () AdS curvature radius l
    # angular momentum J (frame dragging), SLOW-ROTATION model: delays pick
    # up the first-order term -(J/2) int dphi/f along the travel direction
    # (closed form, btz_drag_integral); the orbit SHAPE is kept at J = 0 —
    # exact to O(J^2) by Fermat stationarity of the arrival time under path
    # variation.  Valid for |J| << M l (extremality at |J| = M l); the
    # oracle test quantifies the O(J^2) error.  Arrival/emitter bearings
    # shift at O(J) and are neglected (absorbed by the retina bin width
    # for the spins this model admits).
    spin: jax.Array  # () J

    @staticmethod
    def create(
        center=(0.5, 0.5), mass=0.01, ads_l=4.0, spin=0.0
    ) -> "BTZBlackHole":
        return BTZBlackHole(
            center=jnp.asarray(center, jnp.float32),
            mass=jnp.asarray(mass, jnp.float32),
            ads_l=jnp.asarray(ads_l, jnp.float32),
            spin=jnp.asarray(spin, jnp.float32),
        )

    @property
    def r_h(self):
        return self.ads_l * jnp.sqrt(self.mass)


def btz_null_delay(ra, rb, dphi, mass, ads_l):
    """Coordinate-time delay of the null geodesic from (ra, 0) to
    (rb, dphi), dphi > 0 — fully closed form (module docstring).  Inputs
    broadcast; returns +BIG where an endpoint is inside the horizon."""
    ua = 1.0 / jnp.maximum(ra, _EPS)
    ub = 1.0 / jnp.maximum(rb, _EPS)
    return _null_delay_u(ua, ub, dphi, mass, ads_l)


def btz_null_delay_reflected(ra, rb, dphi, mass, ads_l):
    """Delay of the null geodesic from (ra, 0) to (rb, dphi) that reflects
    ONCE off the AdS conformal boundary (r = infinity, reached in finite
    coordinate time).  Closed form via the signed-u continuation
    (_null_delay_u): the reflected path is the analytic solution of the
    linear orbit ODE u'' = M u with the far endpoint NEGATED in u."""
    ua = 1.0 / jnp.maximum(ra, _EPS)
    ub = 1.0 / jnp.maximum(rb, _EPS)
    return _null_delay_u(ua, -ub, dphi, mass, ads_l)


def _null_delay_u(ua, ub, dphi, mass, ads_l):
    """Signed-u-space core of btz_null_delay: ub < 0 selects the orbit
    reflecting once off the AdS boundary (u = 0).  u'' = M u is linear and
    odd, so the continuation through u = 0 with endpoint -|ub| IS the
    reflected path (|u(phi)| the physical inverse radius): the mirror law
    (radial momentum reverses, E and L conserved) holds at the crossing by
    the sign flip of du/dphi, and every integrand below is even in u, so
    the continued integrals equal the physical ones.  Validity of the
    root-free integration range carries over: on the positive segment u is
    convex (u'' > 0, below the chord to the crossing), on the negative
    concave, so max |u| = max(ua, |ub|) < u_horizon and the w+/- roots
    (|u| = u_horizon touchpoints) stay outside [1, W].  Inputs broadcast;
    +BIG where an endpoint radius is inside the horizon."""
    M, l = mass, ads_l
    mu = jnp.sqrt(M)
    e_half = jnp.exp(mu * dphi)  # e^{mu dphi}
    denom = e_half - 1.0 / e_half
    A = (ub - ua / e_half) / jnp.maximum(denom, _EPS)
    B = ua - A

    Ml2 = M * l * l
    a2 = Ml2 * A * A
    a1 = 1.0 - 2.0 * A * B * Ml2
    a0 = Ml2 * B * B
    # disc = l^2 (E/L)^2 > 0 for exterior endpoints
    disc = jnp.maximum(a1 * a1 - 4.0 * a2 * a0, _EPS)
    sq = jnp.sqrt(disc)

    W = e_half * e_half  # e^{2 mu dphi}, integration upper limit in w

    # general roots; guard a2 ~ 0 (A ~ 0: purely decaying orbit) with the
    # degenerate closed form t = l/(2mu) ln((W - Ml2 B^2)/(1 - Ml2 B^2))
    safe_a2 = jnp.maximum(a2, _EPS)
    w_plus = (a1 + sq) / (2.0 * safe_a2)
    w_minus = (a1 - sq) / (2.0 * safe_a2)

    def g(w):
        return jnp.log(
            jnp.abs(w - w_minus) / jnp.maximum(jnp.abs(w - w_plus), _EPS)
        )

    t_gen = (l / (2.0 * mu)) * (g(W) - g(1.0))
    t_deg = (l / (2.0 * mu)) * jnp.log(
        jnp.abs(W - Ml2 * B * B) / jnp.maximum(jnp.abs(1.0 - Ml2 * B * B), _EPS)
    )
    t = jnp.where(a2 < 1e-9, t_deg, t_gen)

    r_h = l * mu
    ra = 1.0 / jnp.maximum(ua, _EPS)
    rb = 1.0 / jnp.maximum(jnp.abs(ub), _EPS)
    # near-radial geodesics: the BVP solve cancels catastrophically as
    # dphi -> 0 (A ~ 1/dphi); the radial null path has its own closed form
    # t = integral dr / f = (l/2mu) ln[((rb-rh)(ra+rh)) / ((rb+rh)(ra-rh))]
    t_rad = (l / (2.0 * mu)) * jnp.abs(jnp.log(
        jnp.maximum((rb - r_h) * (ra + r_h), _EPS)
        / jnp.maximum((rb + r_h) * (ra - r_h), _EPS)
    ))
    # reflected radial limit: out to the boundary and back, two legs of
    # int_r^inf dr/f = (l/2mu) ln((r+rh)/(r-rh))
    leg = lambda r: jnp.log(
        jnp.maximum(r + r_h, _EPS) / jnp.maximum(r - r_h, _EPS)
    )
    t_rad_reflect = (l / (2.0 * mu)) * (leg(ra) + leg(rb))
    t_rad = jnp.where(ub < 0, t_rad_reflect, t_rad)
    t = jnp.where(dphi < 3e-3, t_rad, t)

    inside = (ra <= r_h) | (rb <= r_h)
    return jnp.where(inside, _BIG, jnp.abs(t))


def btz_drag_integral(ra, rb, dphi, mass, ads_l):
    """int_0^dphi dphi' / f(r(phi')) >= 0 along the SAME closed-form orbit
    as btz_null_delay — the frame-dragging kernel.  Substituting
    w = e^{2 mu phi} (dphi' = dw / (2 mu w)) makes the integrand rational:
    1/f = l^2 u^2/(1 - M l^2 u^2) = (1/M)(w - D)/(D w) with
    D(w) = -a2 w^2 + a1 w - a0 sharing btz_null_delay's roots w+/-, so

        int dphi/f = (1/(2 mu M)) int_1^W (1/D - 1/w) dw
                   = (1/(2 mu M)) [ -(1/sq) ln|(w-w+)/(w-w-)| - ln w ]_1^W

    with W = e^{2 mu dphi} (validated against f64 quadrature to 1e-11; the
    stable co-root w- = 2 a0/(a1 + sq) keeps the f32 error < 2e-4).  A
    slowly-rotating hole's null delay is t(J) = t(0) + s_travel (J/2) *
    this (see BTZBlackHole; s_travel handled by callers)."""
    ua = 1.0 / jnp.maximum(ra, _EPS)
    ub = 1.0 / jnp.maximum(rb, _EPS)
    return _drag_integral_u(ua, ub, dphi, mass, ads_l)


def btz_drag_integral_reflected(ra, rb, dphi, mass, ads_l):
    """btz_drag_integral along the once-AdS-boundary-reflected orbit
    (btz_null_delay_reflected's path)."""
    ua = 1.0 / jnp.maximum(ra, _EPS)
    ub = 1.0 / jnp.maximum(rb, _EPS)
    return _drag_integral_u(ua, -ub, dphi, mass, ads_l)


def _drag_integral_u(ua, ub, dphi, mass, ads_l):
    """Signed-u-space core of btz_drag_integral: ub < 0 = one AdS-boundary
    reflection, via the same continued-orbit argument as _null_delay_u
    (1/f = l^2 u^2/(1 - M l^2 u^2) is even in u)."""
    M, l = mass, ads_l
    mu = jnp.sqrt(M)
    e_half = jnp.exp(mu * dphi)
    denom = e_half - 1.0 / e_half
    A = (ub - ua / e_half) / jnp.maximum(denom, _EPS)
    B = ua - A

    Ml2 = M * l * l
    a2 = Ml2 * A * A
    a1 = 1.0 - 2.0 * A * B * Ml2
    a0 = Ml2 * B * B
    disc = jnp.maximum(a1 * a1 - 4.0 * a2 * a0, _EPS)
    sq = jnp.sqrt(disc)
    W = e_half * e_half

    safe_a2 = jnp.maximum(a2, _EPS)
    w_plus = (a1 + sq) / (2.0 * safe_a2)
    # product-of-roots form: no a1 - sq cancellation (f32-critical)
    w_minus = 2.0 * a0 / jnp.maximum(a1 + sq, _EPS)

    def logratio(wr):
        # ln|(W - wr)/(1 - wr)| with clamped operands
        return jnp.log(
            jnp.maximum(jnp.abs(W - wr), _EPS)
            / jnp.maximum(jnp.abs(1.0 - wr), _EPS)
        )

    core_gen = -(1.0 / sq) * (logratio(w_plus) - logratio(w_minus))
    # degenerate A ~ 0 (purely decaying orbit): D(w) = a1 w - a0,
    # int_1^W dw/D = (1/a1) ln|(a1 W - a0)/(a1 - a0)|
    safe_a1 = jnp.where(jnp.abs(a1) < _EPS, 1.0, a1)
    core_deg = (1.0 / safe_a1) * jnp.log(
        jnp.maximum(jnp.abs(safe_a1 * W - a0), _EPS)
        / jnp.maximum(jnp.abs(safe_a1 - a0), _EPS)
    )
    core = jnp.where(a2 < 1e-9, core_deg, core_gen)
    # ln W = 2 mu dphi exactly — use that, not log(W), for f32 accuracy
    out = core / (2.0 * mu * M) - dphi / M

    # near-radial: the sweep is tiny and f is bounded away from 0 off the
    # horizon -> trapezoid of the endpoints (exact as dphi -> 0)
    ra = 1.0 / jnp.maximum(ua, _EPS)
    rb = 1.0 / jnp.maximum(jnp.abs(ub), _EPS)
    fa = jnp.maximum(ra * ra / (l * l) - M, _EPS)
    fb = jnp.maximum(rb * rb / (l * l) - M, _EPS)
    i_rad = dphi * 0.5 * (1.0 / fa + 1.0 / fb)
    # reflected radial limit: phi(u) is linear in u on each leg as
    # dphi -> 0, so the sweep-average of 1/f is the u-average over BOTH
    # legs: int dphi'/f -> dphi (g(ua) + g(|ub|)) / (ua + |ub|) with
    # g(u) = int_0^u l^2 s^2 ds/(1 - M l^2 s^2) = (artanh(k u)/k - u)/M,
    # k = l sqrt(M) (exterior endpoints keep k u < 1)
    k = l * mu
    g_of = lambda u: (
        jnp.arctanh(jnp.clip(k * u, 0.0, 1.0 - 1e-6)) / k - u
    ) / M
    ub_a = jnp.abs(ub)
    i_rad_reflect = dphi * (g_of(ua) + g_of(ub_a)) / jnp.maximum(
        ua + ub_a, _EPS
    )
    i_rad = jnp.where(ub < 0, i_rad_reflect, i_rad)
    out = jnp.where(dphi < 3e-3, i_rad, out)

    r_h = l * mu
    inside = (ra <= r_h) | (rb <= r_h)
    return jnp.where(inside, 0.0, jnp.maximum(out, 0.0))


def _spin_delay(base, ra, rb, dphi, s, hole: BTZBlackHole):
    """Route delay with the slow-rotation frame-dragging term.  `s` is the
    _orbit_setup travel sense of the camera->emitter sweep; light travels
    emitter->camera, so its signed chart-angle change is -s*dphi and
    t(J) = t(0) - (J/2)(-s) I = t(0) + s (J/2) I.  Co-rotating light
    (travel sense matching sign(J)) arrives EARLIER."""
    drag = hole.spin * 0.5 * s * btz_drag_integral(
        ra, rb, dphi, hole.mass, hole.ads_l
    )
    return jnp.where(base >= _BIG, base, jnp.maximum(base + drag, 0.0))


def _spin_delay_u(base, ua, ub, dphi, s, hole: BTZBlackHole):
    """_spin_delay in signed-u space (ub < 0 = AdS-boundary reflection)."""
    drag = hole.spin * 0.5 * s * _drag_integral_u(
        ua, ub, dphi, hole.mass, hole.ads_l
    )
    return jnp.where(base >= _BIG, base, jnp.maximum(base + drag, 0.0))


def _polar_separation(qx, qy, cx, cy, hole: BTZBlackHole):
    hx, hy = hole.center[0], hole.center[1]
    rqx, rqy = qx - hx, qy - hy
    rcx, rcy = cx - hx, cy - hy
    rq = jnp.sqrt(rqx * rqx + rqy * rqy)
    rc = jnp.sqrt(rcx * rcx + rcy * rcy)
    cos_d = jnp.clip(
        (rqx * rcx + rqy * rcy) / jnp.maximum(rq * rc, _EPS), -1.0, 1.0
    )
    return rq, rc, jnp.arccos(cos_d)  # d_phi in [0, pi]


def _orbit_setup(qx, qy, cx, cy, hole: BTZBlackHole, route: int):
    """Shared orbit-BVP preamble (camera at phi = 0, emitter q at phi =
    dphi): polar decomposition around the hole, route angular separation
    dphi with travel sense s (+/-1), and the orbit coefficients
    u(phi) = A e^{mu phi} + B e^{-mu phi}.

    Route encoding: base = route % 4, winding k = route // 4.  Bases 0/1
    span the minor angle |dphi| / the around-the-back 2 pi - |dphi|; bases
    2/3 are the same two separations with ONE AdS-boundary reflection — the
    emitter endpoint enters the BVP NEGATED in u (u_q_bvp), so A, B
    describe the signed continued orbit (_null_delay_u docstring).  Winding
    k adds 2 pi k to the separation: orbits that circle the hole k extra
    times — the 2+1 analog of higher-order photon-ring images.  Existence
    is unconditional at EVERY winding: a solution positive at both
    endpoints has its (at most one) zero outside the span, so u > 0
    throughout, and convexity (u'' = M u) keeps u <= max(endpoints), i.e.
    outside the horizon.  The same zero-count argument shows MULTI-BOUNCE
    routes do not exist: two boundary reflections would need two zeros of
    A e^{mu phi} + B e^{-mu phi}, which has at most one — after a bounce
    |u| grows monotonically (no turning point: u' = 0 needs e^{2 mu phi} =
    B/A < 0), so the photon never returns to the boundary.

    Every consumer (bearing, emitter direction, orbit sampling, the brute
    oracle) derives from this one function so sign/clip conventions can
    never drift."""
    hx, hy = hole.center[0], hole.center[1]
    mu = jnp.sqrt(hole.mass)
    rqx, rqy = qx - hx, qy - hy
    rcx, rcy = cx - hx, cy - hy
    rq = jnp.sqrt(rqx * rqx + rqy * rqy)
    rc = jnp.sqrt(rcx * rcx + rcy * rcy)
    phi_c = jnp.arctan2(rcy, rcx)
    phi_q = jnp.arctan2(rqy, rqx)
    delta = jnp.mod(phi_q - phi_c + jnp.pi, 2.0 * jnp.pi) - jnp.pi  # [-pi, pi)
    sgn = jnp.where(delta >= 0, 1.0, -1.0)
    base, winding = route % 4, route // 4
    if base % 2 == 0:
        dphi = jnp.clip(jnp.abs(delta), 1e-4, None)
        s = sgn
    else:
        dphi = 2.0 * jnp.pi - jnp.abs(delta)
        s = -sgn
    dphi = dphi + 2.0 * jnp.pi * winding
    u_c = 1.0 / jnp.maximum(rc, _EPS)
    u_q = 1.0 / jnp.maximum(rq, _EPS)
    u_q_bvp = -u_q if base >= 2 else u_q
    e = jnp.exp(mu * dphi)
    A = (u_q_bvp - u_c / e) / jnp.maximum(e - 1.0 / e, _EPS)
    B = u_c - A
    return dict(mu=mu, rq=rq, rc=rc, phi_c=phi_c, dphi=dphi, s=s,
                u_c=u_c, u_q=u_q, u_q_bvp=u_q_bvp, A=A, B=B)


def _tangent_at(ob, phi, sigma=1.0):
    """Chart tangent of the orbit at sweep angle phi (per unit phi, in the
    travel sense s): (dr/dphi) r_hat + r phi_hat.  `sigma` selects the
    physical branch of a reflected (signed-continuation) orbit: +1 before
    the AdS-boundary bounce (camera side), -1 after (emitter side), where
    the physical inverse radius is -u_cont."""
    mu, s = ob["mu"], ob["s"]
    u = ob["A"] * jnp.exp(mu * phi) + ob["B"] * jnp.exp(-mu * phi)
    du = mu * (ob["A"] * jnp.exp(mu * phi) - ob["B"] * jnp.exp(-mu * phi))
    u = sigma * u
    du = sigma * du
    r = 1.0 / jnp.maximum(u, _EPS)
    dr_dphi = -du / jnp.maximum(u * u, _EPS)
    ang = ob["phi_c"] + s * phi
    rhx, rhy = jnp.cos(ang), jnp.sin(ang)
    thx, thy = -rhy * s, rhx * s
    return dr_dphi * rhx + r * thx, dr_dphi * rhy + r * thy


def arrival_bearing_xy(qx, qy, cx, cy, hole: BTZBlackHole, route: int):
    """Chart bearing (radians, atan2 convention) at the CAMERA of the route
    geodesic toward chart point q, plus its delay — closed form.  Thin
    wrapper over route_optics_xy."""
    bearing, delay, _, _ = route_optics_xy(qx, qy, cx, cy, hole, route)
    return bearing, delay


def emitter_direction_xy(qx, qy, cx, cy, hole: BTZBlackHole, route: int):
    """Unit propagation direction of the photon AT THE EMITTER q (pointing
    along its travel toward the camera): minus the camera->emitter orbit
    tangent at phi = dphi, normalized.  Thin wrapper over route_optics_xy."""
    _, _, nex, ney = route_optics_xy(qx, qy, cx, cy, hole, route)
    return nex, ney


def route_optics_xy(qx, qy, cx, cy, hole: BTZBlackHole, route: int):
    """(camera bearing, delay, emitter-side propagation direction) for one
    route — the ONE implementation; arrival_bearing_xy and
    emitter_direction_xy are thin wrappers (XLA DCE prunes their unused
    outputs under jit)."""
    ob = _orbit_setup(qx, qy, cx, cy, hole, route)
    vx, vy = _tangent_at(ob, jnp.zeros_like(ob["dphi"]))
    bearing = jnp.arctan2(vy, vx)
    delay = _null_delay_u(ob["u_c"], ob["u_q_bvp"], ob["dphi"], hole.mass,
                          hole.ads_l)
    # NOTE endpoint order: the orbit is parametrized camera (phi=0) ->
    # emitter (dphi); the drag integral is endpoint-symmetric like the
    # delay, the SIGN carries the physics (_spin_delay docstring)
    delay = _spin_delay_u(
        delay, ob["u_c"], ob["u_q_bvp"], ob["dphi"], ob["s"], hole
    )
    # emitter side of a reflected route lies on the -u branch of the
    # continued orbit (_tangent_at sigma)
    tx, ty = _tangent_at(
        ob, ob["dphi"], sigma=-1.0 if (route % 4) >= 2 else 1.0
    )
    inv = jax.lax.rsqrt(jnp.maximum(tx * tx + ty * ty, _EPS))
    return bearing, delay, -tx * inv, -ty * inv


def sample_orbit(qx, qy, cx, cy, hole: BTZBlackHole, route: int, n: int):
    """(n,) chart points and delays along the route geodesic from the CAMERA
    to q — closed form per sample (oracle/visualization use).  Returns
    (xs, ys, delays) with delays measured from the camera end."""
    hx, hy = hole.center[0], hole.center[1]
    ob = _orbit_setup(qx, qy, cx, cy, hole, route)
    mu = ob["mu"]
    frac = jnp.linspace(0.0, 1.0, n)
    phis = ob["dphi"] * frac
    # signed continued orbit; |u| is the physical inverse radius (reflected
    # routes cross u = 0 at the AdS boundary)
    u = ob["A"] * jnp.exp(mu * phis) + ob["B"] * jnp.exp(-mu * phis)
    r = 1.0 / jnp.maximum(jnp.abs(u), _EPS)
    ang = ob["phi_c"] + ob["s"] * phis
    xs = hx + r * jnp.cos(ang)
    ys = hy + r * jnp.sin(ang)
    # delay from camera to each sample: same closed form, partial upper
    # limit — the signed u keeps the sub-path's BVP on the SAME continued
    # orbit (samples past the bounce re-solve to the same A, B)
    delays = _null_delay_u(ob["u_c"], u, jnp.maximum(phis, 1e-5), hole.mass,
                           hole.ads_l)
    delays = _spin_delay_u(
        delays, ob["u_c"], u, jnp.maximum(phis, 1e-5), ob["s"], hole
    )
    return xs, ys, delays


def _travel_sense(qx, qy, cx, cy, hole: BTZBlackHole):
    """Sign of the wrapped angle phi_q - phi_c (route 0's camera->emitter
    sweep sense; route 1 is its negation) via the cross product — matches
    _orbit_setup's sgn without the arctan2s."""
    hx, hy = hole.center[0], hole.center[1]
    cross = (cx - hx) * (qy - hy) - (cy - hy) * (qx - hx)
    return jnp.where(cross >= 0, 1.0, -1.0)


def route_delay_xy(qx, qy, cx, cy, hole: BTZBlackHole, route: int):
    """One route's delay between chart point q and camera c: base route 0
    spans the minor angle |dphi|, base 1 goes around the back
    (2 pi - |dphi|); bases 2/3 are the same separations with one
    AdS-boundary reflection; winding route // 4 adds 2 pi k (_orbit_setup
    encoding).  Computing routes separately keeps the band search at one
    closed-form evaluation per probe."""
    rq, rc, d_phi = _polar_separation(qx, qy, cx, cy, hole)
    b, winding = route % 4, route // 4
    sep = jnp.maximum(d_phi, 1e-6) if b % 2 == 0 else 2.0 * jnp.pi - d_phi
    sep = sep + 2.0 * jnp.pi * winding
    s = _travel_sense(qx, qy, cx, cy, hole)
    if b % 2:
        s = -s
    uc = 1.0 / jnp.maximum(rc, _EPS)
    uq = 1.0 / jnp.maximum(rq, _EPS)
    ub = -uq if b >= 2 else uq
    base = _null_delay_u(uc, ub, sep, hole.mass, hole.ads_l)
    return _spin_delay_u(base, uc, ub, sep, s, hole)


def route_delays_xy(qx, qy, cx, cy, hole: BTZBlackHole):
    """Both routes' delays (direct |dphi|, around-the-back 2 pi - |dphi|)."""
    rq, rc, d_phi = _polar_separation(qx, qy, cx, cy, hole)
    s = _travel_sense(qx, qy, cx, cy, hole)
    d1 = jnp.maximum(d_phi, 1e-6)
    d2 = 2.0 * jnp.pi - d_phi
    t1 = _spin_delay(
        btz_null_delay(rq, rc, d1, hole.mass, hole.ads_l), rq, rc, d1, s, hole
    )
    t2 = _spin_delay(
        btz_null_delay(rq, rc, d2, hole.mass, hole.ads_l), rq, rc, d2, -s,
        hole,
    )
    return t1, t2


def _select_optics(params: RenderParams):
    """(route_optics, route_delay) per params.btz_exact_spin: the O(J^2)
    slow-rotation closed forms (default) or the full rotating-metric solve
    (ops/btz_exact.py; exact to |J| < M l, ~100x the evaluation cost)."""
    if not params.btz_exact_spin:
        return route_optics_xy, route_delay_xy
    from . import btz_exact

    def optics(qx, qy, cx, cy, hole, route):
        b, d, nx, ny, _fb = btz_exact.exact_route_optics_xy(
            qx, qy, cx, cy, hole, route)
        return b, d, nx, ny

    return optics, btz_exact.exact_route_delay_xy


def _btz_retina(pairs: PairData, cam, t_now, hole: BTZBlackHole, dt, rho,
                n_rays: int, ray_chunk: int = 8192, routes=(0, 1),
                optics=None):
    """1D occlusion retina over ARRIVAL BEARING at the camera: every pair
    whose event is cone-consistent with a route (emitted at t_now - that
    route's delay) scatter-mins its delay into the bearing bins covering its
    angular footprint.  Needs no per-pair route identity: every route is
    tested, the inconsistent ones simply fail the cone gate."""
    pd = pairs.pdata
    cxm, cym = cam.pos[0], cam.pos[1]
    ex = 0.5 * (pd[:, _F_AX] + pd[:, _F_BX])
    ey = 0.5 * (pd[:, _F_AY] + pd[:, _F_BY])
    t_mid = pd[:, _F_TA] + 0.5 * dt
    half_sweep = 0.5 * jnp.sqrt(
        (pd[:, _F_BX] - pd[:, _F_AX]) ** 2 + (pd[:, _F_BY] - pd[:, _F_AY]) ** 2
    )
    chart_d = jnp.sqrt((ex - cxm) ** 2 + (ey - cym) ** 2)
    # angular footprint (first order; the oracle budget absorbs bending of
    # the footprint itself)
    w_ang = (rho + half_sweep) / jnp.maximum(chart_d, 1e-6)

    # dense chunked (rays x pairs) masked-min: elementwise vector math and
    # a reduction, no per-element scatter-min
    betas = (jnp.arange(n_rays, dtype=jnp.float32) + 0.5) * (
        2.0 * _PI / n_rays
    ) - _PI
    retina = jnp.full((n_rays,), _BIG, jnp.float32)
    chunk = max(ray_chunk, 128)
    n_pairs = ex.shape[0]
    n_chunks = -(-n_pairs // chunk)
    pad = n_chunks * chunk - n_pairs

    def padc(a, fill):
        return jnp.pad(a, (0, pad), constant_values=fill).reshape(
            n_chunks, chunk
        )

    for route in routes:
        if optics is None:
            beta, delay = arrival_bearing_xy(ex, ey, cxm, cym, hole, route)
        else:
            beta, delay, _, _ = optics(ex, ey, cxm, cym, hole, route)
        # cone gate: the event really was emitted one route-delay ago
        # (slack: the crossing lies within the tick + capsule radius)
        slack = 1.5 * dt + (rho + half_sweep) * delay / jnp.maximum(chart_d, 1e-6)
        ok = (
            pairs.pair_valid
            & (delay < _BIG)
            & (jnp.abs((t_now - delay) - t_mid) <= slack)
        )
        cb_ = padc(beta, 0.0)
        cd_ = padc(jnp.where(ok, delay, _BIG), _BIG)
        cw_ = padc(w_ang, -1.0)

        def body(ret, args):
            b, d, w = args
            d_ang = jnp.abs(
                jnp.mod(betas[:, None] - b[None, :] + _PI, 2.0 * _PI) - _PI
            )
            val = jnp.where(d_ang <= w[None, :], d[None, :], _BIG)
            return jnp.minimum(ret, jnp.min(val, axis=1)), None

        retina, _ = jax.lax.scan(body, retina, (cb_, cd_, cw_))
    return retina


def _render_btz_impl(
    buf: WorldlineBuffer,
    obj_index: jax.Array,
    objects: Objects,
    cam: Camera,
    hole: BTZBlackHole,
    width: int,
    height: int,
    params: RenderParams,
    planar: bool,
):
    """Retarded render around a BTZ black hole: per pixel, matter is shown
    at the retarded time of whichever of the two geodesic routes hits
    (shortest VISIBLE delay wins) — double images with gravitational time
    delay.  Opaque mode (params.opaque) occludes along the CURVED routes via
    a 1D retina over arrival bearing at the camera (_btz_retina); shading
    uses the exact closed-form arrival direction per route.  Pixels inside
    the horizon render black.  Returns (image, RenderDiag)."""
    dt, rho = params.dt, params.rho
    t_now = buf.times[buf.cursor]
    cxm, cym = cam.pos[0], cam.pos[1]
    use_rays = params.opaque and params.retarded
    bases = (0, 1, 2, 3) if params.btz_reflections else (0, 1)
    route_ids = tuple(
        4 * k + b for k in range(params.btz_windings + 1) for b in bases
    )
    optics_fn, delay_fn = _select_optics(params)

    # NO view-hull culling: curved routes pass through off-screen regions,
    # and off-screen matter must still occlude them / show back-route images
    plist = []
    band_truncated = jnp.int32(0)
    for r in route_ids:
        fn = lambda qx, qy, _r=r: delay_fn(qx, qy, cxm, cym, hole, _r)
        p, trunc, _segd = _band_pairs(buf, obj_index, objects, cam, t_now, width,
                               height, params, route_lengths=fn,
                               cull_hull=False)
        plist.append(p)
        band_truncated = band_truncated + trunc
    pairs = PairData(
        pdata=jnp.concatenate([p.pdata for p in plist], axis=0),
        pair_valid=jnp.concatenate([p.pair_valid for p in plist]),
        n_pairs=sum(p.n_pairs for p in plist),
    )
    from .raytrace import _compact_pairs_to_budget

    # both routes' pairs share one pair_budget; pairs.n_pairs stays the
    # PRE-budget count so Engine._check_diag warns/adapts on overflow
    # (ADVICE r2: this drop used to be silent)
    pairs = _compact_pairs_to_budget(pairs, params.pair_budget)
    tables, bin_dropped, entry_dropped, cell_too_small, geom = _build_view_tables(
        pairs, cam, width, height, params
    )
    wc_img, hc_img, _ps, _gx, _gy = geom
    diag = RenderDiag(
        pairs_used=pairs.n_pairs,
        band_truncated=band_truncated,
        bin_dropped=bin_dropped,
        cell_too_small=cell_too_small,
        retina_dropped=None,
        entry_dropped=entry_dropped,
    )

    n_rays = params.num_rays
    if use_rays:
        retina = _btz_retina(pairs, cam, t_now, hole, dt, rho, n_rays,
                             ray_chunk=params.ray_chunk, routes=route_ids,
                             optics=optics_fn if params.btz_exact_spin
                             else None)
        retina_rows = jnp.broadcast_to(retina[:, None], (n_rays, 8))

    pxs, pys = _cell_pixel_coords(width, height, cam, params)
    cb = params.cells_per_block
    n_blocks = pxs.shape[0] // cb

    def block_fn(args):
        vdat, vok, px, py = args
        chart_d = jnp.maximum(
            jnp.sqrt((px - cxm) ** 2 + (py - cym) ** 2), 1e-6
        )
        routes = []
        for r in route_ids:
            beta, td, nex, ney = optics_fn(px, py, cxm, cym, hole, r)
            occ, win = _occupancy_cells(px, py, t_now - td, vdat, vok, dt, rho)
            occ = occ & (td < _BIG)
            if use_rays:
                ri = jnp.clip(
                    jnp.floor((beta + _PI) / (2 * _PI) * n_rays).astype(jnp.int32),
                    0, n_rays - 1,
                )
                first = retina_rows[ri][..., 0]
                margin = 2.0 * rho * td / chart_d  # delay-units capsule slack
                blk = first < (td - margin)
            else:
                blk = jnp.zeros_like(occ)
            routes.append(dict(td=td, occ=occ, win=win, blk=blk, beta=beta,
                               nex=nex, ney=ney))

        # earliest-arrival winner across K routes (earlier route index wins
        # ties — identical to the historical 2-route td1 <= td2 logic)
        def earliest(mask_key):
            best_td = jnp.full_like(routes[0]["td"], _BIG)
            best_i = jnp.zeros(routes[0]["td"].shape, jnp.int32)
            for i, ro in enumerate(routes):
                v = jnp.where(ro[mask_key], ro["td"], _BIG)
                take = v < best_td
                best_td = jnp.where(take, v, best_td)
                best_i = jnp.where(take, jnp.int32(i), best_i)
            return best_i

        for ro in routes:
            ro["sel"] = ro["occ"] & ~ro["blk"]
        visible = routes[0]["sel"]
        occupied = routes[0]["occ"]
        for ro in routes[1:]:
            visible = visible | ro["sel"]
            occupied = occupied | ro["occ"]
        idx = jnp.where(visible, earliest("sel"), earliest("occ"))
        winner = routes[0]["win"]
        beta_w, nex, ney = routes[0]["beta"], routes[0]["nex"], routes[0]["ney"]
        for i, ro in enumerate(routes[1:], start=1):
            pick = idx == i
            winner = jnp.where(pick[:, :, None], ro["win"], winner)
            beta_w = jnp.where(pick, ro["beta"], beta_w)
            nex = jnp.where(pick, ro["nex"], nex)
            ney = jnp.where(pick, ro["ney"], ney)

        vx = _field_at(vdat, winner, _F_VX)
        vy = _field_at(vdat, winner, _F_VY)
        # exact closed-form ray directions at BOTH ends of the bent route:
        # the source Doppler term uses the emitter-side tangent, the camera
        # term the camera-side (-beta-ward) one
        nx = -jnp.cos(beta_w)
        ny = -jnp.sin(beta_w)
        d = doppler_factor_xy(vx, vy, nex, ney) * camera_doppler_factor_xy(
            cam.vel[0], cam.vel[1], nx, ny
        )
        # gravitational redshift between static frames: nu_obs/nu_emit =
        # sqrt(f(r_emit)/f(r_cam)) — matter deeper in the well reddens
        hx_, hy_ = hole.center[0], hole.center[1]
        r_e = jnp.sqrt((px - hx_) ** 2 + (py - hy_) ** 2)
        r_c = jnp.sqrt((cxm - hx_) ** 2 + (cym - hy_) ** 2)
        f_of = lambda r: jnp.maximum(
            r * r / (hole.ads_l**2) - hole.mass, 0.0
        )
        d = d * jnp.sqrt(f_of(r_e) / jnp.maximum(f_of(r_c), 1e-6))
        cr = _field_at(vdat, winner, _F_CR)
        cg = _field_at(vdat, winner, _F_CG)
        cb_ = _field_at(vdat, winner, _F_CB)
        sr, sg, sb = shade_channels(cr, cg, cb_, d, params)

        # horizon disc renders black
        hx, hy = hole.center[0], hole.center[1]
        in_hole = ((px - hx) ** 2 + (py - hy) ** 2) < hole.r_h**2

        if use_rays:
            all_blocked = routes[0]["blk"] | (routes[0]["td"] >= _BIG)
            any_route = routes[0]["td"] < _BIG
            for ro in routes[1:]:
                all_blocked = all_blocked & (ro["blk"] | (ro["td"] >= _BIG))
                any_route = any_route | (ro["td"] < _BIG)
            bg_blocked = all_blocked & any_route

            def compose(s):
                return jnp.where(
                    in_hole, 0.0,
                    jnp.where(
                        visible, s,
                        jnp.where(
                            occupied, s * params.absorbed_dim,
                            jnp.where(
                                bg_blocked, jnp.float32(params.shadow), 1.0
                            ),
                        ),
                    ),
                )

        else:

            def compose(s):
                return jnp.where(in_hole, 0.0, jnp.where(occupied, s, 1.0))

        return jnp.stack([compose(sr), compose(sg), compose(sb)], axis=1)

    crgb = jax.lax.map(
        block_fn,
        (
            tables.vdat.reshape(n_blocks, cb, *tables.vdat.shape[1:]),
            tables.vok.reshape(n_blocks, cb, *tables.vok.shape[1:]),
            pxs.reshape(n_blocks, cb, -1),
            pys.reshape(n_blocks, cb, -1),
        ),
    )
    img = _assemble_image(crgb, width, height, params, planar, wc_img, hc_img)
    return img, diag


@partial(jax.jit, static_argnames=("width", "height", "params", "planar"))
def render_btz_xray(
    buf: WorldlineBuffer,
    obj_index: jax.Array,
    objects: Objects,
    cam: Camera,
    hole: BTZBlackHole,
    width: int,
    height: int,
    params: RenderParams,
    planar: bool = False,
) -> jax.Array:
    img, _ = _render_btz_impl(
        buf, obj_index, objects, cam, hole, width, height, params, planar
    )
    return img


@partial(jax.jit, static_argnames=("width", "height", "params", "planar"))
def render_btz_with_diag(
    buf: WorldlineBuffer,
    obj_index: jax.Array,
    objects: Objects,
    cam: Camera,
    hole: BTZBlackHole,
    width: int,
    height: int,
    params: RenderParams,
    planar: bool = False,
):
    """(image, RenderDiag) — diagnostics surface for the BTZ path
    (VERDICT r2 #4)."""
    return _render_btz_impl(
        buf, obj_index, objects, cam, hole, width, height, params, planar
    )


# keep the historical name: the renderer now honors params.opaque too
render_btz = render_btz_xray


@partial(jax.jit, static_argnames=("width", "height", "params", "n_samples"))
def render_btz_brute(
    buf: WorldlineBuffer,
    obj_index: jax.Array,
    objects: Objects,
    cam: Camera,
    hole: BTZBlackHole,
    width: int,
    height: int,
    params: RenderParams,
    n_samples: int = 48,
) -> jax.Array:
    """Exhaustive BTZ oracle: per pixel and route, occupancy by testing every
    (slot, particle) segment at the route's retarded time, and OCCLUSION by
    walking `n_samples` closed-form points along the pixel's actual curved
    geodesic, testing every segment at each point's own retarded time.
    Independent of the fast path's bearing-retina — defines correct output
    for render_btz_xray's opaque mode (tiny scenes)."""
    from .raytrace import _occupancy_xy, _segment_data
    from ..camera import pixel_centers

    dt, rho = params.dt, params.rho
    t_now = buf.times[buf.cursor]
    cxm, cym = cam.pos[0], cam.pos[1]
    use_rays = params.opaque and params.retarded
    M, l = hole.mass, hole.ads_l
    mu = jnp.sqrt(M)
    hx, hy = hole.center[0], hole.center[1]

    qax, qay, qbx, qby, ta, seg_valid = _segment_data(buf, dt)
    t_cap, n = qax.shape
    fax, fay = qax.reshape(-1), qay.reshape(-1)
    fbx, fby = qbx.reshape(-1), qby.reshape(-1)
    fta = jnp.repeat(ta, n)
    valid_f = jnp.repeat(seg_valid, n) & (jnp.abs(fax) < 1e8)
    fobj = jnp.tile(obj_index, t_cap)
    fvx = buf.vel_x[:t_cap].reshape(-1)
    fvy = buf.vel_y[:t_cap].reshape(-1)

    pc = pixel_centers(width, height, cam)
    px = pc[..., 0].reshape(-1)
    py = pc[..., 1].reshape(-1)
    chart_d = jnp.maximum(jnp.sqrt((px - cxm) ** 2 + (py - cym) ** 2), 1e-6)

    rp = jnp.sqrt((px - hx) ** 2 + (py - hy) ** 2)
    rc = jnp.sqrt((cxm - hx) ** 2 + (cym - hy) ** 2)

    optics_fn, delay_fn = _select_optics(params)

    def route_pass(route):
        # same _orbit_setup as the fast path: sign/clip conventions shared.
        # With btz_exact_spin the ROUTE DELAY is the exact-metric solve;
        # the occlusion walk keeps the static orbit SHAPE (O(J) deviation,
        # absorbed by the walk's capsule margin like the fast retina's)
        ob = _orbit_setup(px, py, cxm, cym, hole, route)
        dphi, s = ob["dphi"], ob["s"]
        phi_c, A, B = ob["phi_c"], ob["A"], ob["B"]
        if params.btz_exact_spin:
            td = delay_fn(px, py, cxm, cym, hole, route)
        else:
            td = _null_delay_u(ob["u_c"], ob["u_q_bvp"], dphi, M, l)
        inside, dist2 = _occupancy_xy(
            px[:, None], py[:, None], (t_now - td)[:, None],
            fax[None], fay[None], fbx[None], fby[None], fta[None], dt, rho,
        )
        inside = inside & valid_f[None, :]
        dist2 = jnp.where(inside, dist2, _BIG)
        best = jnp.argmin(dist2, axis=1)
        occ = jnp.take_along_axis(inside, best[:, None], axis=1)[:, 0]
        occ = occ & (td < _BIG)

        if not use_rays:
            return td, occ, best, jnp.zeros_like(occ)

        margin = 2.0 * rho * td / chart_d

        def body(blocked, frac):
            phis = dphi * frac
            # signed continued orbit: |u| = physical inverse radius
            # (reflected routes cross u = 0 at the AdS boundary)
            u = A * jnp.exp(mu * phis) + B * jnp.exp(-mu * phis)
            r = 1.0 / jnp.maximum(jnp.abs(u), _EPS)
            ang = phi_c + s * phis
            sx = hx + r * jnp.cos(ang)
            sy = hy + r * jnp.sin(ang)
            dj = _null_delay_u(ob["u_c"], u, jnp.maximum(phis, 1e-5), M, l)
            hit, _ = _occupancy_xy(
                sx[:, None], sy[:, None], (t_now - dj)[:, None],
                fax[None], fay[None], fbx[None], fby[None], fta[None],
                dt, rho,
            )
            hit = jnp.any(hit & valid_f[None, :], axis=1)
            hit = hit & (dj < td - margin) & (dj < _BIG)
            return blocked | hit, None

        fracs = jnp.linspace(0.02, 0.995, n_samples)
        blocked, _ = jax.lax.scan(body, jnp.zeros_like(occ), fracs)
        return td, occ, best, blocked

    bases = (0, 1, 2, 3) if params.btz_reflections else (0, 1)
    route_ids = tuple(
        4 * k + b for k in range(params.btz_windings + 1) for b in bases
    )
    passes = [route_pass(r) for r in route_ids]
    optics = [optics_fn(px, py, cxm, cym, hole, r) for r in route_ids]

    # earliest-arrival winner across K routes (ties -> lower route index,
    # matching the fast path's selection)
    def earliest(masks):
        best_td = jnp.full_like(passes[0][0], _BIG)
        best_i = jnp.zeros(passes[0][0].shape, jnp.int32)
        for i, ((td, _, _, _), m) in enumerate(zip(passes, masks)):
            v = jnp.where(m, td, _BIG)
            take = v < best_td
            best_td = jnp.where(take, v, best_td)
            best_i = jnp.where(take, jnp.int32(i), best_i)
        return best_i

    sels = [occ & ~blk for (_, occ, _, blk) in passes]
    occs = [occ for (_, occ, _, _) in passes]
    visible = sels[0]
    occupied = occs[0]
    for s_, o_ in zip(sels[1:], occs[1:]):
        visible = visible | s_
        occupied = occupied | o_
    idx = jnp.where(visible, earliest(sels), earliest(occs))
    best = passes[0][2]
    beta, nex, ney = optics[0][0], optics[0][2], optics[0][3]
    for i in range(1, len(passes)):
        pick = idx == i
        best = jnp.where(pick, passes[i][2], best)
        beta = jnp.where(pick, optics[i][0], beta)
        nex = jnp.where(pick, optics[i][2], nex)
        ney = jnp.where(pick, optics[i][3], ney)
    nx, ny = -jnp.cos(beta), -jnp.sin(beta)
    obj = fobj[best]
    cr = objects.base_color[:, 0][obj]
    cg = objects.base_color[:, 1][obj]
    cbv = objects.base_color[:, 2][obj]
    wvx, wvy = fvx[best], fvy[best]
    # emitter-side direction for the source term, camera-side for the
    # observer term (same convention as the fast path)
    d = doppler_factor_xy(wvx, wvy, nex, ney) * camera_doppler_factor_xy(
        cam.vel[0], cam.vel[1], nx, ny
    )
    f_of = lambda r: jnp.maximum(r * r / (l * l) - M, 0.0)
    d = d * jnp.sqrt(f_of(rp) / jnp.maximum(f_of(rc), 1e-6))
    sr, sg, sb = shade_channels(cr, cg, cbv, d, params)

    in_hole = rp < hole.r_h
    if use_rays:
        all_blocked = jnp.ones_like(visible)
        any_route = jnp.zeros_like(visible)
        for (td, _, _, blk) in passes:
            all_blocked = all_blocked & (blk | (td >= _BIG))
            any_route = any_route | (td < _BIG)
        bg_blocked = all_blocked & any_route
        comp = lambda sch: jnp.where(
            in_hole, 0.0,
            jnp.where(
                visible, sch,
                jnp.where(
                    occupied, sch * params.absorbed_dim,
                    jnp.where(bg_blocked, jnp.float32(params.shadow), 1.0),
                ),
            ),
        )
    else:
        comp = lambda sch: jnp.where(
            in_hole, 0.0, jnp.where(occupied, sch, 1.0)
        )
    img = jnp.stack([comp(sr), comp(sg), comp(sb)], axis=-1)
    return img.reshape(height, width, 3)
