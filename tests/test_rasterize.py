"""The point renderer (ops/rasterize.render_points — the reference's shipped
debug view) against a plain numpy rasterization of the same particles."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from spacetime_tpu import scene
from spacetime_tpu.camera import Camera, world_to_pixel
from spacetime_tpu.ops import rasterize


def _scene(n_bodies=2, seed=0):
    sb = scene.SceneBuilder()
    rng = np.random.default_rng(seed)
    for i in range(n_bodies):
        c = tuple(rng.uniform(0.2, 0.8, 2))
        sb.add(
            scene.disc_softbody(5, i, c, (0.05, -0.02)),
            base_color=tuple(rng.uniform(0.1, 0.9, 3)),
        )
    return sb.build()


def _landings(particles, objects, cam, w, h):
    """numpy reference: (row, col) -> colors of the particles landing there."""
    px = np.asarray(world_to_pixel(particles.pos, w, h, cam))
    xi = np.round(px[:, 0]).astype(int)
    yi = np.round(px[:, 1]).astype(int)
    act = np.asarray(particles.active)
    colors = np.asarray(objects.base_color)[np.asarray(particles.object_index)]
    table = {}
    for i in range(len(xi)):
        if act[i] and 0 <= xi[i] < w and 0 <= yi[i] < h:
            table.setdefault((yi[i], xi[i]), []).append(colors[i])
    return table


@pytest.mark.parametrize("wh", [(256, 128), (200, 100), (130, 50)])
def test_matches_numpy_reference(wh):
    w, h = wh
    particles, objects = _scene()
    cam = Camera.create(pos=(0.5, 0.5), zoom=1.2)
    img = np.asarray(rasterize.render_points(particles, objects, cam, w, h))
    assert img.shape == (h, w, 3)
    table = _landings(particles, objects, cam, w, h)
    cov = np.any(img != 1.0, axis=-1)
    want = np.zeros((h, w), bool)
    for (y, x) in table:
        want[y, x] = True
    np.testing.assert_array_equal(cov, want)
    # every covered pixel shows one of the particles that landed there
    for (y, x), cands in table.items():
        assert any(np.allclose(img[y, x], c, atol=1e-6) for c in cands)


def _center(particles):
    act = np.asarray(particles.active)
    return tuple(float(v) for v in np.asarray(particles.pos)[act].mean(0))


def test_exact_on_unique_pixels():
    particles, objects = _scene(1)
    # magnified (pixel 0.00023 ls < lattice spacing): one particle per pixel
    cam = Camera.create(pos=_center(particles), zoom=0.06)
    w, h = 256, 256
    table = _landings(particles, objects, cam, w, h)
    assert table and all(len(v) == 1 for v in table.values())
    want = np.ones((h, w, 3), np.float32)
    for (y, x), (c,) in table.items():
        want[y, x] = c
    img = np.asarray(rasterize.render_points(particles, objects, cam, w, h))
    np.testing.assert_allclose(img, want, atol=1e-6)


def test_inactive_and_offscreen_excluded():
    particles, objects = _scene(1)
    # magnified so the disc overflows the top and bottom image edges
    cx, cy = _center(particles)
    act = np.asarray(particles.active).copy()
    live = np.flatnonzero(act)
    act[live[::2]] = False  # every other active particle switched off
    particles = dataclasses.replace(particles, active=jnp.asarray(act))
    cam = Camera.create(pos=(cx + 0.005, cy), zoom=0.03)
    w, h = 128, 64
    px = np.asarray(world_to_pixel(particles.pos, w, h, cam))
    off = (px[:, 1] < -0.5) | (px[:, 1] > h - 0.5)
    assert (np.asarray(particles.active) & off).any()
    img = np.asarray(rasterize.render_points(particles, objects, cam, w, h))
    table = _landings(particles, objects, cam, w, h)
    assert table
    cov = np.any(img != 1.0, axis=-1)
    assert int(cov.sum()) == len(table)
    for (y, x) in table:
        assert cov[y, x]


def test_empty_view_is_white():
    particles, objects = _scene(1)
    cam = Camera.create(pos=(50.0, 50.0), zoom=1.0)
    img = np.asarray(rasterize.render_points(particles, objects, cam, 64, 32))
    assert img.shape == (32, 64, 3)
    assert np.all(img == 1.0)
