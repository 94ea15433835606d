"""Renderer tests: point rasterizer, retarded-time physics (apparent-position
lag, Doppler), and accelerated path vs brute-force oracle (SURVEY.md §4)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from spacetime_tpu import scene
from spacetime_tpu.camera import Camera
from spacetime_tpu.ops import rasterize, raytrace
from spacetime_tpu.ops import worldline as wl
from spacetime_tpu.state import make_objects, pack_particles
from spacetime_tpu.constants import MAX_OBJECTS

H = 0.005

SMALL = raytrace.RenderParams(
    dt=H,
    bin_capacity=64,
    num_rays=512,
)


def fitted(params, w, h, zoom):
    """Params with the view-cell size matched to this view (as Engine does)."""
    return dataclasses.replace(
        params, cell_px=raytrace.auto_cell_px(params, w, h, zoom)
    )


def _drifting_blob_buffer(radius_px, offset, vel, n_ticks, capacity=256, extra=None):
    """Synthesize a history of a rigidly drifting blob (no physics needed)."""
    body = scene.disc_softbody(radius_px, 0, offset, vel)
    sb = scene.SceneBuilder()
    sb.add(body, base_color=(0.2, 0.9, 0.3))
    if extra is not None:
        sb.add(extra, base_color=(0.9, 0.2, 0.3))
    particles, objects = sb.build(capacity=capacity)
    buf = wl.create(n_ticks, particles.capacity)
    p0 = particles.pos
    for k in range(n_ticks):
        t = k * H
        shifted = dataclasses.replace(
            particles, pos=p0 + particles.vel * t
        )
        buf = wl.push_frame(buf, shifted, time=t)
    return buf, particles, objects


def test_point_render_places_particles():
    particles = pack_particles(
        pos=np.array([[0.5, 0.5], [0.6, 0.5]], np.float32),
        vel=np.zeros((2, 2), np.float32),
        neighbors=np.full((2, 8), -1, np.int32),
        object_index=np.array([0, 1], np.int32),
        capacity=64,
    )
    objects = make_objects(MAX_OBJECTS, [{"base_color": (0, 0, 1)}, {"base_color": (1, 0, 0)}])
    cam = Camera.create(pos=(0.5, 0.5), zoom=0.4)
    img = np.asarray(rasterize.render_points(particles, objects, cam, 64, 64))
    # particle 0 at camera center -> blue pixel near (32, 32)
    cy, cx = 31, 31
    patch = img[cy - 1 : cy + 3, cx - 1 : cx + 3]
    assert (patch == [0, 0, 1]).all(axis=-1).any()
    # particle 1 is 0.1 ls right = 16 px right of center
    patch2 = img[cy - 1 : cy + 3, cx + 15 : cx + 19]
    assert (patch2 == [1, 0, 0]).all(axis=-1).any()
    # background white
    assert (img[0, 0] == 1).all()


def test_point_render_out_of_view_dropped():
    particles = pack_particles(
        pos=np.array([[99.0, 99.0]], np.float32),
        vel=np.zeros((1, 2), np.float32),
        neighbors=np.full((1, 8), -1, np.int32),
        object_index=np.zeros(1, np.int32),
        capacity=64,
    )
    objects = make_objects(MAX_OBJECTS)
    img = np.asarray(
        rasterize.render_points(particles, objects, Camera.create(), 32, 32)
    )
    assert (img == 1.0).all()


def _centroid(img):
    """Centroid of non-background pixels (use x-ray renders only: opaque-mode
    shadows would pollute this)."""
    mask = img.min(-1) < 0.9
    ys, xs = np.nonzero(mask)
    assert len(xs) > 0, "no colored pixels"
    return xs.mean(), ys.mean()


def test_retarded_position_lags_motion():
    """A blob drifting +y seen from a distant camera appears at its RETARDED
    position: displaced by ~ -v * distance along its motion."""
    # blob at x=0.3 right of camera, moving +y at 0.5c
    buf, particles, objects = _drifting_blob_buffer(
        4, offset=(0.3, -0.25 * 0.5 * 0.3), vel=(0.0, 0.5), n_ticks=128
    )
    cam = Camera.create(pos=(0.0, 0.0), zoom=0.8)
    # x-ray mode: no occlusion shadow to pollute the centroid measurement
    img_ret = np.asarray(
        raytrace.render_retarded_brute(
            buf, particles.object_index, objects, cam, 96, 96,
            dataclasses.replace(SMALL, opaque=False),
        )
    )
    # non-retarded comparison: same scene, occupancy at t_now everywhere ->
    # approximate by a camera extremely close... instead compare against the
    # analytically expected apparent displacement.
    # true y at t_now=0.635*... : y_true(t_now) vs apparent y(t_now - r).
    t_now = (128 - 1) * H
    blob_x = 0.3 + 4 * scene.constants.IMMEDIATE_NEIGHBOR_DIST  # center offset
    # solve r = |p - cam| with p = (blob_x, y0 + v (t_now - r)) iteratively
    y0 = -0.25 * 0.5 * 0.3 + 4 * scene.constants.IMMEDIATE_NEIGHBOR_DIST
    r = blob_x
    for _ in range(20):
        y_app = y0 + 0.5 * (t_now - r)
        r = np.hypot(blob_x, y_app)
    cx, cy = _centroid(img_ret)
    # pixel -> world
    scale = 0.8 / 96
    wx = (cx - 47.5) * scale
    wy = (cy - 47.5) * scale
    np.testing.assert_allclose(wx, blob_x, atol=0.02)
    np.testing.assert_allclose(wy, y_app, atol=0.02)
    # and it must NOT be at the instantaneous position
    y_true = y0 + 0.5 * t_now
    assert abs(wy - y_true) > 0.05


def test_doppler_blueshift_on_approach():
    """Blob approaching the camera head-on renders blue-shifted & brighter;
    receding renders red-shifted & dimmer (green base color shifts)."""
    for vel, expect in ((-0.5, "blue"), (0.5, "red")):
        buf, particles, objects = _drifting_blob_buffer(
            3, offset=(0.4, 0.0), vel=(vel, 0.0), n_ticks=96
        )
        cam = Camera.create(pos=(0.0, 0.0), zoom=1.0)
        img = np.asarray(
            raytrace.render_retarded_brute(
                buf, particles.object_index, objects, cam, 64, 64,
                dataclasses.replace(SMALL, opaque=False),
            )
        )
        mask = img.min(-1) < 0.9
        assert mask.any()
        mean_rgb = img[mask].mean(0)
        if expect == "blue":
            assert mean_rgb[2] > mean_rgb[0]
        else:
            assert mean_rgb[0] >= mean_rgb[2] * 0.999 and mean_rgb[2] < 0.3


def test_fast_matches_oracle_xray():
    params = dataclasses.replace(SMALL, opaque=False)
    buf, particles, objects = _drifting_blob_buffer(
        4, offset=(0.15, 0.05), vel=(0.2, -0.1), n_ticks=64,
        extra=scene.disc_softbody(3, 1, (-0.1, -0.15), (0.1, 0.25)),
    )
    cam = Camera.create(pos=(0.0, 0.0), zoom=0.7)
    a = np.asarray(
        raytrace.render_retarded_brute(buf, particles.object_index, objects, cam, 72, 72, params)
    )
    b, diag = raytrace.render_retarded_with_diag(
        buf, particles.object_index, objects, cam, 72, 72, fitted(params, 72, 72, 0.7)
    )
    b = np.asarray(b)
    assert int(diag.pairs_used) > 0
    assert int(diag.bin_dropped) == 0
    assert not bool(diag.cell_too_small)
    mismatch = np.mean(np.any(np.abs(a - b) > 1e-3, axis=-1))
    assert mismatch < 0.01, f"{mismatch:.3%} pixels differ"


@pytest.mark.parametrize("splat_cells", [9, 4])
def test_auto_cell_px_meets_the_splat_coverage(splat_cells):
    """The fitted view cell is the least that covers the splat mode (2x2
    corner splats need twice the 3x3 edge), so cell_too_small stays off and
    the fast path still matches the oracle."""
    params = dataclasses.replace(SMALL, opaque=False, splat_cells=splat_cells,
                                 bin_capacity=256)
    zoom, w = 0.7, 72
    k = raytrace.auto_cell_px(params, w, w, zoom)
    px = zoom / w
    edge = raytrace.min_cell_edge(params)
    assert k * px >= edge > (k - 1) * px
    buf, particles, objects = _drifting_blob_buffer(
        4, offset=(0.15, 0.05), vel=(0.2, -0.1), n_ticks=64,
    )
    cam = Camera.create(pos=(0.0, 0.0), zoom=zoom)
    a = np.asarray(raytrace.render_retarded_brute(
        buf, particles.object_index, objects, cam, w, w, params))
    b, diag = raytrace.render_retarded_with_diag(
        buf, particles.object_index, objects, cam, w, w,
        dataclasses.replace(params, cell_px=k))
    assert not bool(diag.cell_too_small)
    assert int(diag.bin_dropped) == 0
    mismatch = np.mean(np.any(np.abs(a - np.asarray(b)) > 1e-3, axis=-1))
    assert mismatch < 0.01, f"{mismatch:.3%} pixels differ"


def test_fast_matches_oracle_opaque():
    buf, particles, objects = _drifting_blob_buffer(
        4, offset=(0.15, 0.05), vel=(0.2, -0.1), n_ticks=64,
        extra=scene.disc_softbody(3, 1, (-0.1, -0.15), (0.1, 0.25)),
    )
    cam = Camera.create(pos=(0.0, 0.0), zoom=0.7)
    a = np.asarray(
        raytrace.render_retarded_brute(buf, particles.object_index, objects, cam, 72, 72, SMALL)
    )
    b = np.asarray(
        raytrace.render_retarded(
            buf, particles.object_index, objects, cam, 72, 72, fitted(SMALL, 72, 72, 0.7)
        )
    )
    # retina quantization affects shadow edges only -> small mismatch budget
    mismatch = np.mean(np.any(np.abs(a - b) > 1e-3, axis=-1))
    assert mismatch < 0.03, f"{mismatch:.3%} pixels differ"


def test_occlusion_shadow_behind_blob():
    """In opaque mode the region behind a blob (as seen from the camera) is
    darkened; in x-ray mode it is background white."""
    buf, particles, objects = _drifting_blob_buffer(
        4, offset=(0.2, -0.014), vel=(0.0, 0.0), n_ticks=48
    )
    cam = Camera.create(pos=(0.0, 0.0), zoom=1.0)
    img_op = np.asarray(
        raytrace.render_retarded_brute(buf, particles.object_index, objects, cam, 64, 64, SMALL)
    )
    params_x = dataclasses.replace(SMALL, opaque=False)
    img_x = np.asarray(
        raytrace.render_retarded_brute(buf, particles.object_index, objects, cam, 64, 64, params_x)
    )
    # point far behind the blob along +x: pixel at world (0.45, 0) = px (~76, 32) out of range;
    # use world (0.4, 0) -> px x = 31.5 + 0.4/1.0*64 = 57
    assert img_op[31, 57].max() < 0.95  # shadowed
    assert (img_x[31, 57] == 1.0).all()  # x-ray: background


def test_pair_budget_compaction_preserves_image():
    """Compacting pairs to a budget >= the valid count must not change the
    render at all (the flagship perf path)."""
    buf, particles, objects = _drifting_blob_buffer(
        4, offset=(0.15, 0.05), vel=(0.2, -0.1), n_ticks=64,
        extra=scene.disc_softbody(3, 1, (-0.1, -0.15), (0.1, 0.25)),
    )
    cam = Camera.create(pos=(0.0, 0.0), zoom=0.7)
    p_nobudget = dataclasses.replace(fitted(SMALL, 72, 72, 0.7), pair_budget=0)
    p_budget = dataclasses.replace(p_nobudget, pair_budget=1024)
    a, diag = raytrace.render_retarded_with_diag(
        buf, particles.object_index, objects, cam, 72, 72, p_nobudget
    )
    assert int(diag.pairs_used) < 1024  # budget is not binding
    b = raytrace.render_retarded(
        buf, particles.object_index, objects, cam, 72, 72, p_budget
    )
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_retina_boundary_culling_close_to_full():
    """Boundary-only occlusion pairs (worldline.boundary_mask wired into the
    retina march) must produce nearly the same opaque image as marching all
    pairs: interior discs sit behind the overlapping boundary layer."""
    import dataclasses as dc

    from spacetime_tpu import scene as scene_mod
    from spacetime_tpu.models.softbody import SoftbodyModel
    from spacetime_tpu.ops import worldline as wlops

    sb = scene_mod.SceneBuilder()
    sb.add(scene_mod.disc_softbody(7, 0, (0.40, 0.42), (0.2, 0.1)),
           base_color=(0.25, 0.35, 1.0))
    sb.add(scene_mod.disc_softbody(7, 1, (0.60, 0.55), (-0.2, -0.1)),
           base_color=(1.0, 0.3, 0.25))
    p, objects = sb.build(capacity=512)
    model = SoftbodyModel(capacity=p.capacity)
    buf = wlops.create(64, p.capacity)
    t = 0.0
    for _ in range(40):
        p, _ = model.step(p)
        t += model.params.h
        buf = wlops.push_frame(buf, p, jnp.float32(t))
    cam = Camera.create(pos=(0.5, 0.5), zoom=0.6)
    base = raytrace.RenderParams(
        dt=model.params.h, num_rays=512, bin_capacity=32, cell_px=16,
        pair_budget=0, backend="xla",
    )
    full = raytrace.render_retarded(
        buf, p.object_index, objects, cam, 64, 64, base
    )
    culled = raytrace.render_retarded(
        buf, p.object_index, objects, cam, 64, 64,
        dc.replace(base, retina_budget=1024),
        boundary=wlops.boundary_mask(p),
    )
    diff = np.abs(np.asarray(full) - np.asarray(culled)).max(-1)
    assert (diff > 0.05).mean() < 0.01  # <1% of pixels may shift


def test_max_age_bounded_sweep_exact():
    """A view-covering max_age must not change the image at all: the skipped
    ages are beyond every pixel's light cone."""
    import dataclasses as dc

    buf, particles, objects = _drifting_blob_buffer(
        5, (0.42, 0.45), (0.2, 0.1), n_ticks=256
    )
    cam = Camera.create(pos=(0.5, 0.5), zoom=0.6)
    base = raytrace.RenderParams(
        dt=H, num_rays=256, bin_capacity=32, cell_px=16,
        pair_budget=0, backend="xla",
    )
    full = raytrace.render_retarded(
        buf, particles.object_index, objects, cam, 64, 64, base
    )
    # view corner = 0.3*sqrt(2) = 0.42 ls = 85 ticks; 128 covers it
    bounded = raytrace.render_retarded(
        buf, particles.object_index, objects, cam, 64, 64,
        dc.replace(base, max_age=128),
    )
    np.testing.assert_array_equal(np.asarray(full), np.asarray(bounded))


def test_bin_overflow_keeps_nearest_candidates():
    """When a view cell overflows bin_capacity, the NEAREST candidates (by
    distance to the cell) are retained and the farthest dropped — graceful
    degradation past the adaptation ceiling (VERDICT r2 #7), not arbitrary
    first-k retention."""
    cam = Camera.create(pos=(0.5, 0.5), zoom=1.0)
    width = height = 64
    params = raytrace.RenderParams(bin_capacity=4, cell_px=16, splat_cells=9)
    # 12 tiny segments along a line crossing one cell region, pair i at
    # increasing distance from the camera-centered cell's center
    n = 12
    xs = 0.5 + 0.004 * np.arange(n)
    pd = np.full((n, 10), 0.0, np.float32)
    pd[:, 0] = xs  # ax
    pd[:, 1] = 0.5  # ay
    pd[:, 2] = xs  # bx
    pd[:, 3] = 0.5  # by
    pairs = raytrace.PairData(
        pdata=jnp.asarray(pd),
        pair_valid=jnp.ones((n,), bool),
        n_pairs=jnp.int32(n),
    )
    vslot, dropped, _edrop, _small, geom = raytrace._splat_vslot(
        pairs, cam, width, height, params
    )
    assert int(dropped) > 0
    wc_img, hc_img, pixel_size, x0, y0 = geom
    lam = params.cell_px * pixel_size
    vs = np.asarray(vslot)  # (hc, wc, cap)
    # for every overflowing cell: max kept distance <= min dropped distance
    for cy in range(vs.shape[0]):
        for cx in range(vs.shape[1]):
            kept = set(vs[cy, cx][vs[cy, cx] >= 0].tolist())
            if not kept:
                continue
            lox = x0 - 0.5 * pixel_size + cx * lam
            loy = y0 - 0.5 * pixel_size + cy * lam
            d = np.hypot(
                np.clip(xs, lox, lox + lam) - xs,
                np.clip(0.5, loy, loy + lam) - 0.5,
            )
            # candidates that splat into this cell but were dropped
            reach = params.reach
            in_cell = d <= reach + 1e-6
            dropped_ids = [i for i in range(n) if in_cell[i] and i not in kept]
            if dropped_ids:
                assert max(d[list(kept)]) <= min(d[dropped_ids]) + lam * 0.2


def test_entry_budget_slice_preserves_image():
    """A sorted-entry prefix slice covering all valid splat entries must not
    change the render (the bin scatter is the top render op at reference
    scale; refdemo.py opts in).  An undersized budget must COUNT the
    overflow in RenderDiag.entry_dropped."""
    buf, particles, objects = _drifting_blob_buffer(
        4, offset=(0.15, 0.05), vel=(0.2, -0.1), n_ticks=64,
        extra=scene.disc_softbody(3, 1, (-0.1, -0.15), (0.1, 0.25)),
    )
    cam = Camera.create(pos=(0.0, 0.0), zoom=0.7)
    p0 = fitted(SMALL, 72, 72, 0.7)
    a, diag = raytrace.render_retarded_with_diag(
        buf, particles.object_index, objects, cam, 72, 72, p0
    )
    n_valid = int(diag.pairs_used)
    assert n_valid > 16
    # generous budget: image identical, nothing dropped
    p_fit = dataclasses.replace(p0, entry_budget=9 * n_valid + 128)
    b, diag_fit = raytrace.render_retarded_with_diag(
        buf, particles.object_index, objects, cam, 72, 72, p_fit
    )
    assert int(diag_fit.entry_dropped) == 0
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
    # starved budget: overflow counted (adaptation evidence), never silent
    p_tiny = dataclasses.replace(p0, entry_budget=128)
    _, diag_tiny = raytrace.render_retarded_with_diag(
        buf, particles.object_index, objects, cam, 72, 72, p_tiny
    )
    assert int(diag_tiny.entry_dropped) > 0
