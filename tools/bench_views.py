"""Multi-observer serving bench: B cameras over one stored worldline ring
in ONE jitted program (raytrace.render_views) vs B separate render
dispatches.  Measures per-view ms / views-per-second at the flagship scene
(10k particles, 1080p, history 1024).

Usage: python tools/bench_views.py [B ...]   (default batches: 1 4 8)
"""

import sys
import time

import jax

sys.path.insert(0, ".")

from spacetime_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

from spacetime_tpu.camera import Camera, stack_cameras  # noqa: E402
from spacetime_tpu.ops import raytrace  # noqa: E402
from spacetime_tpu.ops import worldline as wl  # noqa: E402


def orbit_cameras(center, zoom, b):
    """B cameras on a small ring around the scene center (distinct views)."""
    import math

    cams = []
    for i in range(b):
        ang = 2.0 * math.pi * i / max(b, 1)
        cams.append(Camera.create(
            pos=(center[0] + 0.08 * math.cos(ang),
                 center[1] + 0.08 * math.sin(ang)),
            zoom=zoom,
        ))
    return cams


def main():
    from spacetime_tpu.engine import Engine
    from spacetime_tpu.utils.config import get_config

    batches = [int(a) for a in sys.argv[1:] if a.isdigit()] or [1, 4, 8]
    eng = Engine(get_config("flagship_1080p"))
    # advance a few frames so the ring holds real (post-step) history
    for _ in range(8):
        img = eng.run_frame()
    jax.block_until_ready(img)
    cfg = eng.config
    w, h = cfg.width, cfg.height
    params = eng._render_params()
    b, p, objects = eng.worldline, eng.particles, eng.objects
    boundary = wl.boundary_mask(p)
    obj_index = p.object_index

    # ring/objects must be ARGUMENTS, not closure captures: captured arrays
    # compile in as multi-MB literal constants
    def _single(buf_, oi_, objs_, bnd_, cam_):
        return raytrace.render_retarded(
            buf_, oi_, objs_, cam_, w, h, params, planar=True, boundary=bnd_)

    single_j = jax.jit(_single)
    single = lambda c: single_j(b, obj_index, objects, boundary, c)  # noqa: E731

    print(f"{'B':>3s} {'mode':>8s} {'ms/view':>8s} {'views/s':>8s}")
    for nb in batches:
        cams = orbit_cameras(cfg.cam_pos, cfg.cam_zoom, nb)
        stacked = stack_cameras(cams)

        # batched: one dispatch for all views
        out = raytrace.render_views(b, obj_index, objects, stacked, w, h,
                                    params, planar=True, boundary=boundary)
        jax.block_until_ready(out)
        reps = max(1, 24 // nb)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = raytrace.render_views(b, obj_index, objects, stacked, w, h,
                                        params, planar=True,
                                        boundary=boundary)
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / (reps * nb) * 1e3
        print(f"{nb:3d} {'batched':>8s} {ms:8.2f} {1e3 / ms:8.1f}")

        # per-dispatch loop over the same cameras
        for c in cams:
            img = single(c)
        jax.block_until_ready(img)
        t0 = time.perf_counter()
        for _ in range(reps):
            for c in cams:
                img = single(c)
        jax.block_until_ready(img)
        ms = (time.perf_counter() - t0) / (reps * nb) * 1e3
        print(f"{nb:3d} {'loop':>8s} {ms:8.2f} {1e3 / ms:8.1f}")


if __name__ == "__main__":
    main()
