"""Capacity run: 2^20 particles — the reference's stated limit
(MAX_PARTICLES = 1 << 20, /root/reference/src/twoplusone/softbody/mod.rs:226).

Two 1024 x 512 box lattices on a collision course; box bodies have zero
lattice-pad waste, so capacity == particle count == 2^20 exactly.

Default: physics-only stepping (the XLA cell-table collision path).
`--frame` additionally benches a FULL fused frame (physics step +
worldline push + retarded opaque render) at capacity: history 128 keeps the
mirrored (2T, N) ring at ~4.3 GB; the 960x540 camera watches the collision
interface (the cone sweep still scans every worldline — visibility culling
happens at pair compaction, not in the sweep).
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from spacetime_tpu import scene  # noqa: E402
from spacetime_tpu.models.softbody import SoftbodyModel  # noqa: E402
from spacetime_tpu.ops import forces as forces_ops  # noqa: E402
from spacetime_tpu.utils.cache import enable_compilation_cache  # noqa: E402
from spacetime_tpu.utils.device import card, require_gpu  # noqa: E402

enable_compilation_cache()


def main():
    info = require_gpu()
    print(f"# {info} | {card()}", file=sys.stderr)
    sb = scene.SceneBuilder()
    sb.add(
        scene.mask_to_softbody(
            scene.box_mask(1024, 512), 0, (0.0, 0.0), (0.0, 0.05),
            lattice_pad=True,
        ),
        base_color=(0.25, 0.35, 1.0),
    )
    sb.add(
        scene.mask_to_softbody(
            scene.box_mask(1024, 512), 1, (0.0, 1.85), (0.0, -0.05),
            lattice_pad=True,
        ),
        base_color=(1.0, 0.3, 0.25),
    )
    particles, objects = sb.build()
    n = int(particles.num_active())
    assert particles.capacity == 1 << 20, particles.capacity
    print(f"# particles: {n} (capacity {particles.capacity} = 2^20)",
          file=sys.stderr)

    # scene spans 1024*0.0035 = 3.58 ls: grid 768*0.005 = 3.84 ls
    model = SoftbodyModel(
        capacity=particles.capacity,
        grid_dim=768,
        spring_offsets=forces_ops.derive_spring_offsets(
            np.asarray(particles.neighbors)
        ),
    )
    step = jax.jit(lambda p: model.step(p))

    p, aux = step(particles)
    jax.block_until_ready(p.pos)
    t0 = time.perf_counter()
    n_steps = 30
    for _ in range(n_steps):
        p, aux = step(p)
    jax.block_until_ready(p.pos)
    dt = (time.perf_counter() - t0) / n_steps
    print(
        f"# physics step: {dt*1e3:.2f} ms ({1/dt:.1f} steps/s, "
        f"{n/dt/1e6:.0f} M particle-steps/s); "
        f"grid_overflow={int(aux.grid_overflow)}",
        file=sys.stderr,
    )

    if "--frame" in sys.argv:
        bench_frame(p, objects, model)


def bench_frame(particles, objects, model, history=128,
                width=960, height=540):
    """Full fused frame at 2^20 (VERDICT r2 #10: render at capacity, not
    just physics).  The boxes close their 0.06 ls gap at 0.1 ls/s, so after
    the physics bench's warm steps the camera at (1.79, 1.82) zoom 0.9 sees
    the contact interface; max_age = view corner 103 ticks + band + 8 -> 128
    (the engine's own formula) = the whole ring."""
    from spacetime_tpu.camera import Camera
    from spacetime_tpu.ops import raytrace
    from spacetime_tpu.ops import worldline as wl
    from spacetime_tpu.utils import roofline

    h = model.params.h
    params = raytrace.RenderParams(
        dt=h, num_rays=4096, pair_budget=131072, bin_capacity=128,
        cell_px=16, occlusion_downsample=2, ray_chunk=8192,
        band=4, splat_cells=4, retina_budget=16384, max_age=0,
    )
    cam = Camera.create(pos=(1.79, 1.82), zoom=0.9)
    buf = wl.create(history, particles.capacity)
    buf = wl.prefill_inertial(
        buf, particles.pos, particles.vel, particles.active,
        jnp.float32(0.0), jnp.float32(h),
    )

    def frame(particles, buf, t):
        t = t + jnp.float32(h)
        particles, _aux = model.step(particles)
        buf = wl.push_frame(buf, particles, t)
        img = raytrace.render_retarded(
            buf, particles.object_index, objects, cam, width, height,
            params, planar=True, boundary=wl.boundary_mask(particles),
        )
        return particles, buf, img, t

    frame = jax.jit(frame, donate_argnums=(0, 1, 2))
    frame_cost = roofline.cost_of(
        frame.lower(particles, buf, jnp.float32(0.0)).compile()
    )

    t = jnp.float32(0.0)
    p, b = particles, buf
    t0 = time.perf_counter()
    for _ in range(3):
        p, b, img, t = frame(p, b, t)
    jax.block_until_ready(img)
    print(f"# frame warmup+compile: {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)

    n_frames = 15
    t0 = time.perf_counter()
    for _ in range(n_frames):
        p, b, img, t = frame(p, b, t)
    jax.block_until_ready(img)
    dt_frame = (time.perf_counter() - t0) / n_frames

    img2, diag = raytrace.render_retarded_with_diag(
        b, p.object_index, objects, cam, width, height, params, planar=True)
    rl = roofline.Roofline(*frame_cost, seconds=dt_frame,
                           chip=roofline.chip_kind())
    print(
        f"# fused frame @ 2^20: {dt_frame*1e3:.2f} ms "
        f"({1/dt_frame:.1f} fps) at {width}x{height}, history {history}; "
        f"pairs={int(diag.pairs_used)} dropped={int(diag.bin_dropped)} "
        f"trunc={int(diag.band_truncated)}",
        file=sys.stderr,
    )
    print(f"# frame roofline: {rl.summary()}", file=sys.stderr)


if __name__ == "__main__":
    main()
