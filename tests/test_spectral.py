"""Spectral (blackbody) Doppler shading — the opt-in physically-based
upgrade of the 3-band hat model (ACCURACY.md #10; RenderParams.spectral).

Physics oracle: the observed/emitted channel ratio for a blackbody at rest
temperature T seen under total Doppler factor D is
    expm1(h nu_c / k T) / expm1(h nu_c / (k T D))
(frequency-form Planck ratio; beaming included exactly — derivation in
ops/raytrace.planck_channel_factor).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np

from spacetime_tpu.ops import raytrace
from spacetime_tpu.ops.raytrace import (
    _HC_OVER_K,
    _LAMBDA_RGB,
    RenderParams,
    planck_channel_factor,
    shade_channels,
)


def _params(**kw):
    return RenderParams(spectral=True, ambient=0.0, **kw)


def test_identity_at_rest():
    """D = 1 must reproduce the albedo exactly (a static scene is
    indistinguishable from non-spectral shading with ambient=0)."""
    cr, cg, cb = jnp.float32(0.3), jnp.float32(0.6), jnp.float32(0.9)
    d = jnp.float32(1.0)
    sr, sg, sb = shade_channels(cr, cg, cb, d, _params())
    np.testing.assert_allclose(
        [float(sr), float(sg), float(sb)], [0.3, 0.6, 0.9], rtol=1e-6
    )


def test_matches_float64_planck_oracle():
    """The per-channel factor matches the exact expm1 ratio computed in
    float64, over a range of Doppler factors and temperatures."""
    for temp in (3000.0, 6500.0, 12000.0):
        for d in (0.6, 0.8, 1.0, 1.25, 1.7):
            for lam in _LAMBDA_RGB:
                x = _HC_OVER_K / (lam * temp)
                want = math.expm1(x) / math.expm1(x / d)
                got = float(planck_channel_factor(
                    jnp.float32(d), lam, temp
                ))
                np.testing.assert_allclose(got, want, rtol=2e-4)


def test_blueshift_brightens_blue_more_than_red():
    """Approaching matter (D > 1): every channel brightens, blue most
    (larger x_c); receding (D < 1): dims, blue most."""
    t0 = 6500.0
    fr = float(planck_channel_factor(jnp.float32(1.3), _LAMBDA_RGB[0], t0))
    fb = float(planck_channel_factor(jnp.float32(1.3), _LAMBDA_RGB[2], t0))
    assert fb > fr > 1.0
    fr2 = float(planck_channel_factor(jnp.float32(0.7), _LAMBDA_RGB[0], t0))
    fb2 = float(planck_channel_factor(jnp.float32(0.7), _LAMBDA_RGB[2], t0))
    assert fb2 < fr2 < 1.0


def test_beaming_inherent_not_doubled():
    """The D^3 beaming flag must NOT stack on top of the spectral model
    (the Planck frequency-form ratio already contains it)."""
    cr = cg = cb = jnp.float32(0.5)
    d = jnp.float32(1.4)
    with_flag = shade_channels(cr, cg, cb, d, _params(beaming=True))
    without = shade_channels(cr, cg, cb, d, _params(beaming=False))
    np.testing.assert_allclose(
        [float(x) for x in with_flag], [float(x) for x in without], rtol=1e-7
    )


def test_low_temperature_stability():
    """Sub-360 K emitter temperatures used to overflow float32 expm1
    (x = hc/k/(lam T) > 88) and produce NaN/0 factors (ADVICE r4); the
    stable exp-difference form stays finite and keeps the D = 1 albedo
    identity for any user-settable temperature."""
    for temp in (50.0, 300.0, 350.0):
        for lam in _LAMBDA_RGB:
            at_rest = float(planck_channel_factor(jnp.float32(1.0), lam, temp))
            np.testing.assert_allclose(at_rest, 1.0, rtol=1e-5)
            for d in (0.5, 0.9, 1.1, 2.0):
                got = float(planck_channel_factor(jnp.float32(d), lam, temp))
                assert np.isfinite(got), (temp, lam, d)
                assert got >= 0.0
                # monotone: blueshift brightens, redshift dims
                assert (got >= 1.0) == (d >= 1.0)


def _spectral_scene():
    from spacetime_tpu import scene
    from spacetime_tpu.camera import Camera
    from spacetime_tpu.models.softbody import SoftbodyModel
    from spacetime_tpu.ops import worldline as wl

    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(4, 0, (0.45, 0.5), (0.6, 0.0)),
           base_color=(0.8, 0.7, 0.6))
    particles, objects = sb.build(capacity=256)
    model = SoftbodyModel(capacity=256)
    buf = wl.create(32, 256)
    buf = wl.prefill_inertial(
        buf, particles.pos, particles.vel, particles.active,
        jnp.float32(0.0), jnp.float32(model.params.h),
    )
    buf = wl.push_frame(buf, particles, 0.0)
    cam = Camera.create(pos=(0.5, 0.5), zoom=0.5)
    base = RenderParams(num_rays=128)
    base = dataclasses.replace(
        base, cell_px=raytrace.auto_cell_px(base, 48, 48, 0.5)
    )
    return particles, objects, buf, cam, base


def test_spectral_render_end_to_end():
    """A moving-blob scene rendered with spectral shading: finite, non-white,
    and measurably different from the hat-model image."""
    particles, objects, buf, cam, base = _spectral_scene()
    spec = dataclasses.replace(base, spectral=True)
    img_hat = raytrace.render_retarded(
        buf, particles.object_index, objects, cam, 48, 48, base
    )
    img_spec = raytrace.render_retarded(
        buf, particles.object_index, objects, cam, 48, 48, spec
    )
    a, b = np.asarray(img_hat), np.asarray(img_spec)
    assert np.isfinite(b).all()
    assert (b < 0.999).any(), "spectral render came out all-white"
    assert np.abs(a - b).max() > 1e-3, "spectral flag had no visible effect"


def test_spectral_kernel_matches_xla():
    """Spectral (blackbody) shading in the Triton pixel kernel (interpret
    mode) matches the XLA path to float tolerance, so spectral=True keeps
    the fused kernel."""
    particles, objects, buf, cam, base = _spectral_scene()
    spec_x = dataclasses.replace(base, spectral=True, backend="xla")
    spec_t = dataclasses.replace(
        base, spectral=True, backend="triton", triton_interpret=True
    )
    img_x = raytrace.render_retarded(
        buf, particles.object_index, objects, cam, 48, 48, spec_x
    )
    img_t = raytrace.render_retarded(
        buf, particles.object_index, objects, cam, 48, 48, spec_t
    )
    np.testing.assert_allclose(
        np.asarray(img_t), np.asarray(img_x), atol=1e-5
    )
