"""Camera-frame (boosted observer) map view — ops/boost.py + the
`camera_frame` RenderParams flag.

The reference's archived observer-frame design (`Perspective` /
`view_from_observer`, reference: src/twoplusone/object_archive.txt:20-99)
wanted the scene as laid out in the *moving camera's* instantaneous rest
frame.  These tests pin the closed-form warp (invertibility, the classical
gamma*(1+v)d / gamma*(1-v)d retarded-position limits) and production-vs-
oracle parity of the warped render on all backends.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from spacetime_tpu import scene
from spacetime_tpu.camera import Camera
from spacetime_tpu.ops import boost, raytrace
from spacetime_tpu.ops import worldline as wl

H = 0.005


def _blob_buffer(radius_px, offset, vel, n_ticks, capacity=512):
    body = scene.disc_softbody(radius_px, 0, offset, vel)
    sb = scene.SceneBuilder()
    sb.add(body, base_color=(0.2, 0.9, 0.3))
    particles, objects = sb.build(capacity=capacity)
    buf = wl.create(n_ticks, particles.capacity)
    p0 = particles.pos
    for k in range(n_ticks):
        t = k * H
        buf = wl.push_frame(
            buf, dataclasses.replace(particles, pos=p0 + particles.vel * t),
            time=t,
        )
    return buf, particles, objects


def test_warp_roundtrip_exact():
    rng = np.random.default_rng(0)
    dx = jnp.array(rng.uniform(-5, 5, 512), jnp.float32)
    dy = jnp.array(rng.uniform(-5, 5, 512), jnp.float32)
    for vx, vy in [(0.0, 0.0), (0.3, 0.0), (0.0, -0.5), (0.4, 0.4), (0.69, 0.1)]:
        ux, uy = boost.warp_xy(dx, dy, vx, vy)
        bx, by = boost.unwarp_xy(ux, uy, vx, vy)
        err = float(jnp.max(jnp.abs(bx - dx) + jnp.abs(by - dy)))
        assert err < 1e-5, f"v=({vx},{vy}): roundtrip err {err}"


def test_warp_physical_limits():
    """A source at ground cone distance d directly ahead of the motion plots
    at gamma*(1+v)*d in the boosted view; directly behind at gamma*(1-v)*d —
    the classical retarded-position result."""
    v = 0.6
    g = 1.0 / np.sqrt(1 - v * v)
    ux, _ = boost.warp_xy(jnp.array([2.0]), jnp.array([0.0]), v, 0.0)
    assert abs(float(ux[0]) - g * (1 + v) * 2.0) < 1e-5
    ux, _ = boost.warp_xy(jnp.array([-2.0]), jnp.array([0.0]), v, 0.0)
    assert abs(float(ux[0]) + g * (1 - v) * 2.0) < 1e-5
    # transverse offsets are unchanged in the perpendicular component
    ux, uy = boost.warp_xy(jnp.array([0.0]), jnp.array([1.5]), v, 0.0)
    assert abs(float(uy[0]) - 1.5) < 1e-6


def test_warp_jacobian_bounded_by_stretch():
    """stretch() = gamma*(1+|v|) bounds the forward warp's local expansion
    (used to scale splat reach conservatively in _splat_keys)."""
    rng = np.random.default_rng(1)
    dx = jnp.array(rng.uniform(-3, 3, 2048), jnp.float32)
    dy = jnp.array(rng.uniform(-3, 3, 2048), jnp.float32)
    eps = 1e-3
    for vx, vy in [(0.5, 0.0), (0.3, 0.4)]:
        s = float(boost.stretch(vx, vy))
        for ex, ey in [(eps, 0.0), (0.0, eps), (eps / 1.414, eps / 1.414)]:
            ux0, uy0 = boost.warp_xy(dx, dy, vx, vy)
            ux1, uy1 = boost.warp_xy(dx + ex, dy + ey, vx, vy)
            d = jnp.sqrt((ux1 - ux0) ** 2 + (uy1 - uy0) ** 2) / eps
            assert float(jnp.max(d)) <= s * 1.01


@pytest.mark.parametrize("backend", ["xla", "triton"])
def test_camera_frame_matches_oracle(backend):
    """Production warped render == brute warped oracle (opaque + x-ray), on
    both pixel passes (the Triton kernel in interpret mode)."""
    buf, particles, objects = _blob_buffer(10, (0.6, 0.45), (0.0, 0.0), 192)
    cam = Camera.create(pos=(0.35, 0.5), zoom=1.2, vel=(0.5, 0.0))
    params = raytrace.RenderParams(
        dt=H, bin_capacity=64, num_rays=512, camera_frame=True,
        backend=backend, triton_interpret=backend == "triton",
    )
    params = dataclasses.replace(
        params, cell_px=raytrace.auto_cell_px(params, 72, 72, 1.2)
    )
    for opaque in (True, False):
        p = dataclasses.replace(params, opaque=opaque)
        brute = np.asarray(
            raytrace.render_retarded_brute(
                buf, particles.object_index, objects, cam, 72, 72, p
            )
        )
        fast = np.asarray(
            raytrace.render_retarded(
                buf, particles.object_index, objects, cam, 72, 72, p
            )
        )
        mism = (np.abs(fast - brute).max(-1) > 0.05).mean()
        budget = 0.03 if opaque else 0.01
        assert mism < budget, f"opaque={opaque}: {mism:.3%} pixels differ"


def test_camera_frame_displaces_ahead_source():
    """The boosted view plots a static source AHEAD of the camera's motion
    farther away than the ground view: offset scales by gamma*(1+v)."""
    buf, particles, objects = _blob_buffer(8, (0.6, 0.45), (0.0, 0.0), 192)
    v = 0.5
    cam = Camera.create(pos=(0.35, 0.5), zoom=1.2, vel=(v, 0.0))
    base = raytrace.RenderParams(
        dt=H, bin_capacity=64, num_rays=512, opaque=False, backend="xla"
    )
    base = dataclasses.replace(
        base, cell_px=raytrace.auto_cell_px(base, 72, 72, 1.2)
    )

    def centroid_x(p):
        img = np.asarray(
            raytrace.render_retarded(
                buf, particles.object_index, objects, cam, 72, 72, p
            )
        )
        mask = img.min(-1) < 0.9
        ys, xs = np.nonzero(mask)
        assert len(xs) > 0
        return (xs.mean() - (72 - 1) / 2) * (1.2 / 72)

    dg = centroid_x(base)
    db = centroid_x(dataclasses.replace(base, camera_frame=True))
    g = 1.0 / np.sqrt(1 - v * v)
    assert abs(db / dg - g * (1 + v)) < 0.05, (dg, db)


def test_camera_frame_requires_retarded():
    buf, particles, objects = _blob_buffer(6, (0.6, 0.45), (0.0, 0.0), 32)
    cam = Camera.create(vel=(0.3, 0.0))
    p = raytrace.RenderParams(dt=H, camera_frame=True, retarded=False)
    with pytest.raises(ValueError, match="retarded"):
        raytrace.render_retarded(
            buf, particles.object_index, objects, cam, 32, 32, p
        )
