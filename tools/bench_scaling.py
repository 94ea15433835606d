"""Scaling measurement for the sharded physics step / fused frame.

The reference is strictly single-GPU (SURVEY.md §2: one queue, no multi-
device anything); scaling is a rebuild axis.  test_parallel.py proves
*correctness* (numerics + partition specs + bounded all-gather volume);
this tool produces the *measurement*: per-device-count step/frame times and
the exact collective traffic the compiled program moves per step, parsed
from the optimized HLO.

Without real multi-chip hardware the timings run on a virtual CPU mesh
(xla_force_host_platform_device_count) — RELATIVE numbers only (host cores
emulate chips, no real interconnect), but the collective-bytes column is
exact: it is the traffic XLA schedules for the given mesh.  With --real
the same tool times whatever devices JAX exposes (e.g. four GPUs).

Usage:
  python tools/bench_scaling.py                 # weak scaling, 8192/dev
  python tools/bench_scaling.py --strong 65536  # strong scaling, fixed N
  python tools/bench_scaling.py --frame         # include fused frame rows
Each row prints as one JSON line; a summary table follows on stderr.
"""

import argparse
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Default to the virtual CPU mesh (set up BEFORE importing jax); --real
# uses whatever devices the session exposes.
if "--real" not in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spacetime_tpu import scene  # noqa: E402
from spacetime_tpu.camera import Camera  # noqa: E402
from spacetime_tpu.models.softbody import SoftbodyModel  # noqa: E402
from spacetime_tpu.ops import raytrace  # noqa: E402
from spacetime_tpu.ops import worldline as wl  # noqa: E402
from spacetime_tpu.parallel import mesh as mesh_mod  # noqa: E402
from spacetime_tpu.parallel import sharding  # noqa: E402

# Collectives that move bytes between shards in optimized HLO.  all-gather /
# all-reduce / reduce-scatter / collective-permute / all-to-all, both the
# sync form and the -start half of the async pair (the -done half carries
# the same shape; counting starts only avoids double counting).
_COLLECTIVE = re.compile(
    r"=\s*(\S+)\s+(all-gather|all-reduce|reduce-scatter|collective-permute|"
    r"all-to-all)(\(|-start\()"
)
_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1}


def _shape_bytes(shape_str: str) -> int:
    """Bytes of one HLO shape string like 'f32[2048,32]{1,0}' or a tuple
    '(f32[8]{0}, s32[8]{0})'."""
    total = 0
    for m in re.finditer(r"(\w+)\[([\d,]*)\]", shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Sum output bytes per collective kind over the optimized HLO."""
    out = {}
    for line in hlo_text.splitlines():
        m = _COLLECTIVE.search(line)
        if not m:
            continue
        kind = m.group(2)
        out[kind] = out.get(kind, 0) + _shape_bytes(m.group(1))
    out["total"] = sum(out.values())
    return out


def build_scene(capacity: int):
    """Lattice discs filling ~60% of capacity (step cost is set by the
    static capacity, not the active count — SoA arrays are dense)."""
    sb = scene.SceneBuilder()
    # each disc of radius r has ~pi r^2 particles; place two on a collision
    # course (the reference's default-scene shape) sized to the capacity
    import math

    r = max(3, int(math.sqrt(0.3 * capacity / math.pi)))
    d = scene.disc_softbody
    sb.add(d(r, 0, (0.45, 0.45), (0.1, 0.1)), base_color=(0, 0, 1))
    sb.add(d(r, 1, (0.75, 0.75), (-0.1, -0.1)), base_color=(1, 0, 0))
    particles, objects = sb.build(capacity=capacity)
    return particles, objects


def run_row(ndev: int, capacity: int, mode: str, do_frame: bool,
            steps: int, history: int, res: int):
    m = mesh_mod.make_mesh(ndev)
    particles, objects = build_scene(capacity)
    model = SoftbodyModel(capacity=capacity)
    buf = wl.create(history, capacity)
    buf = wl.prefill_inertial(
        buf, particles.pos, particles.vel, particles.active,
        jnp.float32(0.0), jnp.float32(model.params.h))
    p_sh, b_sh = sharding.shard_state(particles, buf, m)

    rows = []

    # --- physics step ---
    step = sharding.make_sharded_step(model, m)
    cb = collective_bytes(step.lower(p_sh).compile().as_text())

    p = step(p_sh)
    jax.block_until_ready(p)
    t0 = time.perf_counter()
    for _ in range(steps):
        p = step(p)
    jax.block_until_ready(p)
    dt = (time.perf_counter() - t0) / steps
    rows.append({
        "bench": f"{mode}_step", "devices": ndev, "capacity": capacity,
        "ms_per_step": round(dt * 1e3, 3),
        "steps_per_s": round(1.0 / dt, 2),
        "collective_bytes_per_step": cb["total"],
        "collective_breakdown": {k: v for k, v in cb.items() if k != "total"},
    })

    if do_frame:
        params = raytrace.RenderParams(num_rays=256, backend="xla")
        import dataclasses as dc

        params = dc.replace(
            params, cell_px=raytrace.auto_cell_px(params, res, res, 0.5))
        cam = Camera.create(pos=(0.6, 0.6), zoom=0.5)
        frame = sharding.make_sharded_frame(
            model, objects, params, res, res, m)
        cbf = collective_bytes(
            frame.lower(p_sh, b_sh, cam, jnp.float32(0.005))
            .compile().as_text())
        pp, bb, img = frame(p_sh, b_sh, cam, jnp.float32(0.005))
        jax.block_until_ready(img)
        t0 = time.perf_counter()
        t = 0.005
        for _ in range(max(3, steps // 4)):
            t += model.params.h
            pp, bb, img = frame(pp, bb, cam, jnp.float32(t))
        jax.block_until_ready(img)
        dt = (time.perf_counter() - t0) / max(3, steps // 4)
        rows.append({
            "bench": f"{mode}_frame", "devices": ndev, "capacity": capacity,
            "resolution": res, "ms_per_frame": round(dt * 1e3, 3),
            "collective_bytes_per_frame": cbf["total"],
            "collective_breakdown": {k: v for k, v in cbf.items()
                                     if k != "total"},
        })
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--n-per-dev", type=int, default=8192,
                    help="weak scaling: capacity per device")
    ap.add_argument("--strong", type=int, default=0,
                    help="strong scaling: fixed total capacity")
    ap.add_argument("--frame", action="store_true",
                    help="also time the fused sharded frame")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--history", type=int, default=64)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--real", action="store_true",
                    help="use the session's real devices (no CPU mesh)")
    args = ap.parse_args()

    devs = [int(d) for d in args.devices.split(",")]
    avail = len(jax.devices())
    devs = [d for d in devs if d <= avail]
    print(f"# backend={jax.default_backend()} devices available={avail}",
          file=sys.stderr)

    all_rows = []
    for nd in devs:
        if args.strong:
            cap, mode = args.strong, "strong"
        else:
            cap, mode = args.n_per_dev * nd, "weak"
        cap = mesh_mod.pad_to_multiple(cap, 8 * nd)
        rows = run_row(nd, cap, mode, args.frame, args.steps,
                       args.history, args.res)
        for r in rows:
            print(json.dumps(r))
            all_rows.append(r)

    # summary table (stderr)
    print(f"\n{'bench':14} {'dev':>3} {'capacity':>9} {'ms':>9} "
          f"{'coll KB':>9}", file=sys.stderr)
    for r in all_rows:
        ms = r.get("ms_per_step", r.get("ms_per_frame"))
        cb = r.get("collective_bytes_per_step",
                   r.get("collective_bytes_per_frame"))
        print(f"{r['bench']:14} {r['devices']:>3} {r['capacity']:>9} "
              f"{ms:>9.3f} {cb / 1024:>9.1f}", file=sys.stderr)


if __name__ == "__main__":
    main()
