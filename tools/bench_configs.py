"""Measure fused-frame time for every named config on the GPU.
Usage: python tools/bench_configs.py [name ...]"""

import sys
import time

import jax

sys.path.insert(0, ".")

from spacetime_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

from spacetime_tpu.engine import Engine  # noqa: E402
from spacetime_tpu.utils.config import CONFIGS, get_config  # noqa: E402


def bench(name, warm=100, timed=40):
    # warm past 3x diag_every (30): the diagnostics-driven band/bin
    # adaptation may recompile (geometric, <= 2 events) — steady state is
    # what we measure
    cfg = get_config(name)
    eng = Engine(cfg)
    # pipelined throughput: no host sync per frame
    eng.sync_per_frame = False
    t0 = time.perf_counter()
    img = None
    for _ in range(warm):
        img = eng.run_frame()
    jax.block_until_ready(img)
    compile_s = time.perf_counter() - t0
    # best of 3 windows: diagnostics-driven adaptation may recompile INSIDE
    # a timed window as the scene evolves (e.g. the flagship collision
    # densifies bins ~frame 150); a compile landing mid-window inflates
    # that window's mean.  The min is the settled program's
    # throughput at this scene epoch (frames `warm`..`warm+3*timed`).
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(timed):
            img = eng.run_frame()
        jax.block_until_ready(img)
        dt = min(dt, (time.perf_counter() - t0) / timed)
    n = int(eng.particles.num_active())
    print(
        f"{name:22s} {n:7d} particles {cfg.width}x{cfg.height} "
        f"history {cfg.history:4d}  frame {dt*1e3:7.2f} ms  "
        f"fps {1.0/dt:6.1f}  (compile+warm {compile_s:.0f}s)",
        flush=True,
    )


def main():
    names = sys.argv[1:] or list(CONFIGS)
    for name in names:
        bench(name)


if __name__ == "__main__":
    main()
