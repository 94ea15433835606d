"""Render the BTZ photon-ring showcase (README): winding-1 + boundary-echo
routes around a spinning hole — up to eight images per emitter, the deepest
having circled the hole once (~700-850 ticks of extra lookback).

Builds the 1024-tick worldline history directly (two blobs on linear
trajectories past the hole) so the render is CPU-feasible; the engine path
produces the same images via the `btz_photon_ring` config.
Usage: python tools/showcase_photon_ring.py
"""

import dataclasses
import sys

import jax
import numpy as np

sys.path.insert(0, ".")

from spacetime_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

from spacetime_tpu import scene  # noqa: E402
from spacetime_tpu.camera import Camera  # noqa: E402
from spacetime_tpu.engine import save_png  # noqa: E402
from spacetime_tpu.ops import btz, raytrace  # noqa: E402
from spacetime_tpu.ops import worldline as wl  # noqa: E402

H = 0.005


def main():
    sb = scene.SceneBuilder()
    # slow drifts keep 1024 ticks of history inside the frame while the
    # winding/echo images (deep lookback) land visibly elsewhere; both
    # paths SKIRT the hole — a trajectory through the horizon would put
    # its retarded images inside it (frozen/black)
    sb.add(scene.disc_softbody(6, 0, (0.28, -0.26), (0.04, 0.10)),
           base_color=(0.25, 0.45, 1.0))
    sb.add(scene.disc_softbody(6, 1, (-0.38, 0.10), (0.06, 0.04)),
           base_color=(1.0, 0.35, 0.2))
    particles, objects = sb.build(capacity=512)
    buf = wl.create(1024, particles.capacity)
    p0 = particles.pos
    for k in range(1024):
        t = k * H
        buf = wl.push_frame(
            buf, dataclasses.replace(particles, pos=p0 + particles.vel * t),
            time=t)

    cam = Camera.create(pos=(0.0, -0.30), zoom=1.4)
    hole = btz.BTZBlackHole.create(center=(0.0, 0.0), mass=0.03, ads_l=0.45,
                                   spin=0.008)
    base = raytrace.RenderParams(dt=H, opaque=False, btz_reflections=True,
                                 btz_windings=1)
    params = dataclasses.replace(
        base, cell_px=raytrace.auto_cell_px(base, 384, 384, 1.1))
    img = btz.render_btz_xray(buf, particles.object_index, objects, cam,
                              hole, 384, 384, params)
    save_png("assets/showcase_btz_photon_ring.png", img)
    arr = np.asarray(img)
    print("assets/showcase_btz_photon_ring.png:", arr.shape,
          "image px:", int((arr.min(-1) < 0.9).sum()), flush=True)


if __name__ == "__main__":
    main()
