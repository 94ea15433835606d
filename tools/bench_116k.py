"""Reference-demo benchmark: the reference's ACTUAL default scene —
testimg4 at the origin with velocity (0.1, 0.1) and testimg5 at (1.2, 0.8)
with velocity (-0.1, -0.1) (/root/reference/src/twoplusone/mod.rs:86-113),
loaded through the PNG import path at 1080p retarded render (scene built in
tools/refdemo.py).  Usage: python tools/bench_116k.py [history] [--points]

--points benches the APPLES-TO-APPLES frame: physics step + worldline push
+ the non-relativistic point renderer — the pipeline the reference actually
ships (its raytracer is an empty stub, raytrace.glsl:11-21; the shipped
debug view is point_render_nr.rs).  The retarded default row renders a
capability the reference does not have."""

import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from spacetime_tpu.ops import rasterize, raytrace  # noqa: E402
from spacetime_tpu.ops import worldline as wl  # noqa: E402
from spacetime_tpu.utils.cache import enable_compilation_cache  # noqa: E402
from spacetime_tpu.utils.device import card, require_gpu  # noqa: E402
from tools import refdemo  # noqa: E402

enable_compilation_cache()


def main():
    info = require_gpu()
    print(f"# {info} | {card()}", file=sys.stderr)
    points = "--points" in sys.argv
    pos_args = [a for a in sys.argv[1:] if not a.startswith("-")]
    history = int(pos_args[0]) if pos_args else 1024
    width, height = refdemo.WIDTH, refdemo.HEIGHT
    particles, objects, model, buf, cam, params = refdemo.build(history)
    print(f"# particles: {int(particles.num_active())}, capacity "
          f"{particles.capacity}, history {history}", file=sys.stderr)

    def frame(particles, buf, cam, t):
        # t stays on device across frames
        t = t + jnp.float32(model.params.h)
        particles, _aux = model.step(particles)
        buf = wl.push_frame(buf, particles, t)
        if points:
            img = rasterize.render_points(particles, objects, cam, width,
                                          height)
        else:
            img = raytrace.render_retarded(
                buf, particles.object_index, objects, cam, width, height,
                params, planar=True, boundary=wl.boundary_mask(particles),
            )
        return particles, buf, img, t

    frame = jax.jit(frame, donate_argnums=(0, 1, 3))
    step_only = jax.jit(lambda p: model.step(p)[0])

    from spacetime_tpu.utils import roofline

    frame_cost = roofline.cost_of(
        frame.lower(particles, buf, cam, jnp.float32(0.0)).compile()
    )
    step_cost = roofline.cost_of(step_only.lower(particles).compile())

    t = jnp.float32(0.0)
    p, b = particles, buf
    t0 = time.perf_counter()
    for _ in range(5):
        p, b, img, t = frame(p, b, cam, t)
    jax.block_until_ready(img)
    print(f"# warmup+compile: {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    n_frames = 30
    t0 = time.perf_counter()
    for _ in range(n_frames):
        p, b, img, t = frame(p, b, cam, t)
    jax.block_until_ready(img)
    dt_frame = (time.perf_counter() - t0) / n_frames

    p2 = step_only(p)
    jax.block_until_ready(p2)
    t0 = time.perf_counter()
    for _ in range(50):
        p2 = step_only(p2)
    jax.block_until_ready(p2)
    sps = 50 / (time.perf_counter() - t0)

    # diagnostics at the final state
    if points:
        diag_txt = ""
    else:
        img2, diag = raytrace.render_retarded_with_diag(
            b, p.object_index, objects, cam, width, height, params,
            planar=True)
        diag_txt = (
            f"pairs={int(diag.pairs_used)} dropped={int(diag.bin_dropped)} "
            f"trunc={int(diag.band_truncated)} "
            f"entry_dropped={int(diag.entry_dropped)} "
            f"segment_dropped={int(diag.segment_dropped or 0)}"
        )
    print(
        f"# fused frame: {dt_frame*1e3:.2f} ms ({1/dt_frame:.1f} fps); "
        f"physics-only: {sps:.0f} steps/s ({1e3/sps:.1f} ms); " + diag_txt,
        file=sys.stderr,
    )
    rl = roofline.Roofline(*frame_cost, seconds=dt_frame,
                           chip=roofline.chip_kind())
    rls = roofline.Roofline(*step_cost, seconds=1.0 / sps,
                            chip=roofline.chip_kind())
    print(f"# frame roofline: {rl.summary()}", file=sys.stderr)
    print(f"# step  roofline: {rls.summary()}", file=sys.stderr)


if __name__ == "__main__":
    main()
