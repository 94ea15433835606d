"""Triton pixel-pass kernel (ops/pixel_triton.py) parity vs the XLA block map.

Both passes shade the same candidates in the same sorted order with the same
f32 formulas (occupancy, first-min winner, Doppler/beaming or spectral
shading, retina occlusion, composition), so images must match to float
tolerance in every mode.  The kernel runs in Pallas interpret mode here."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from spacetime_tpu import scene
from spacetime_tpu.camera import Camera
from spacetime_tpu.models.softbody import SoftbodyModel
from spacetime_tpu.ops import pixel_triton
from spacetime_tpu.ops import raytrace as rt
from spacetime_tpu.ops import worldline as wl


@pytest.fixture(scope="module")
def small_scene():
    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(6, 0, (0.40, 0.42), (0.3, 0.1)),
           base_color=(0.25, 0.35, 1.0))
    sb.add(scene.disc_softbody(6, 1, (0.60, 0.55), (-0.3, -0.1)),
           base_color=(1.0, 0.3, 0.25))
    p, objects = sb.build(capacity=256)
    model = SoftbodyModel(capacity=p.capacity)
    buf = wl.create(64, p.capacity)
    t = 0.0
    for _ in range(40):
        p, _ = model.step(p)
        t += model.params.h
        buf = wl.push_frame(buf, p, jnp.float32(t))
    cam = Camera.create(pos=(0.5, 0.5), zoom=0.6, vel=(0.1, 0.05))
    return p, objects, model, buf, cam


def _both(small_scene, width, height, cam=None, planar=False,
          interpret=True, **kw):
    p, objects, model, buf, cam0 = small_scene
    kw = {"bin_capacity": 32, "cell_px": 16, **kw}
    base = rt.RenderParams(dt=model.params.h, num_rays=512, pair_budget=0,
                           **kw)
    out = []
    for params in (dataclasses.replace(base, backend="xla"),
                   dataclasses.replace(base, backend="triton",
                                       triton_interpret=interpret)):
        img, diag = rt.render_retarded_with_diag(
            buf, p.object_index, objects, cam or cam0, width, height, params,
            planar=planar,
        )
        out.append((np.asarray(img), diag))
    return out


@pytest.mark.parametrize(
    "opaque,retarded", [(True, True), (False, True), (True, False)],
    ids=["retarded-opaque", "xray", "instant"],
)
def test_triton_kernel_matches_xla(small_scene, opaque, retarded):
    (img_x, dx), (img_t, dtr) = _both(
        small_scene, 64, 64, opaque=opaque, retarded=retarded
    )
    assert img_t.shape == img_x.shape == (64, 64, 3)
    np.testing.assert_allclose(img_t, img_x, atol=1e-5)
    # the same nearest-k retention: the kernel counts drops in image cells
    # only, the block map also in the halo ring around the image
    assert 0 <= int(dtr.bin_dropped) <= int(dx.bin_dropped)
    assert int(dtr.pairs_used) == int(dx.pairs_used)


def test_triton_kernel_spectral(small_scene):
    (img_x, _), (img_t, _) = _both(small_scene, 64, 64, spectral=True,
                                   spectral_temp=5000.0)
    np.testing.assert_allclose(img_t, img_x, atol=1e-5)


def test_triton_kernel_camera_frame(small_scene):
    p, objects, model, buf, cam = small_scene
    fast = Camera.create(pos=(0.5, 0.5), zoom=0.6, vel=(0.5, 0.1))
    (img_x, _), (img_t, _) = _both(small_scene, 64, 64, cam=fast,
                                   camera_frame=True, bin_capacity=64)
    np.testing.assert_allclose(img_t, img_x, atol=1e-5)


def test_triton_kernel_odd_cell_px_and_planar(small_scene):
    """Non-power-of-two cells (81 pixels in a 128-pixel program) and an
    image whose edge cells are partly outside it."""
    (img_x, _), (img_t, _) = _both(small_scene, 63, 45, planar=True,
                                   cell_px=9)
    assert img_t.shape == (3, 45, 63)
    np.testing.assert_allclose(img_t, img_x, atol=1e-5)


def test_triton_kernel_empty_view(small_scene):
    """A view with no matter in it renders pure background in both."""
    far = Camera.create(pos=(5.0, 5.0), zoom=0.3)
    (img_x, _), (img_t, _) = _both(small_scene, 32, 32, cam=far)
    np.testing.assert_array_equal(img_t, img_x)
    assert np.all(img_t == 1.0)


def test_pixel_block_is_power_of_two():
    assert [pixel_triton.pixel_block(k) for k in (8, 9, 16, 24, 48)] == [
        64, 128, 256, 1024, 4096
    ]


# --- on the card: the kernel as compiled for the GPU ----------------------


def _off(a, b):
    d = np.abs(a - b).max(axis=-1)
    return float((d > 1e-3).mean()), float(d[d <= 1e-3].max(initial=0.0))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "kw", [{}, {"opaque": False}, {"retarded": False}, {"spectral": True},
           {"cell_px": 9}],
    ids=["retarded-opaque", "xray", "instant", "spectral", "odd-cell"],
)
def test_triton_kernel_compiled_matches_xla(gpu, small_scene, kw):
    """Both passes on the GPU: the same f32 formulas, so pixels agree up to
    the order of the min-reduction and GPU transcendental ulps."""
    (img_x, _), (img_t, _) = _both(small_scene, 63, 45, interpret=False,
                                   **kw)
    frac, rest = _off(img_t, img_x)
    assert frac < 0.002 and rest <= 1e-4, (frac, rest)


@pytest.mark.gpu
def test_engine_frames_on_gpu_take_the_triton_pass(gpu):
    import dataclasses as dc

    import jax

    from spacetime_tpu import paths
    from spacetime_tpu.engine import Engine
    from spacetime_tpu.utils.config import get_config

    assert paths.pixel_path("auto") == "triton"
    cfg = dc.replace(get_config("single_blob"), width=128, height=96)
    eng = Engine(cfg)
    for _ in range(3):
        img = eng.run_frame()
    img = np.asarray(jax.block_until_ready(img))
    assert img.shape == (96, 128, 3) and np.isfinite(img).all()
    assert (img < 0.999).any()
    assert int(eng.last_aux.grid_overflow) == 0
