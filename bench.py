"""Headline benchmark: the flagship_1080p config (10k particles, 1080p
retarded-time render, history 1024) through Engine on one GPU: steady-state
fused-frame time (physics step + worldline push + render), physics-only
steps/s, and the device busy/idle split and per-stage device time from a
profiler trace.

Prints the device (platform, device_kind, count) and the card's name and
power limit on stderr, then ONE JSON line on stdout:
{"metric", "value", "unit", "vs_baseline", ...}.  vs_baseline is fps / 72,
the frame-pacing bar the reference set for itself (debugui.rs:21).  Fails
when JAX's default device is not a GPU.

Replay-driven A/B regression harness:
    python bench.py --record s.jsonl [--config NAME] [--frames N]
        record a deterministic scripted session + write s.jsonl.perf.json
    python bench.py --replay s.jsonl
        re-drive the EXACT recorded inputs (bit-reproducible on one
        backend), print one JSON perf line, write s.jsonl.perf.json
    python bench.py --diff a.perf.json b.perf.json
        CI-style JSON diff (pct deltas + regression flag)
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp

from spacetime_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

PACING_FPS = 72.0  # reference: src/debugui.rs:21


def main():
    from spacetime_tpu.engine import Engine
    from spacetime_tpu.utils import device, profiling, roofline
    from spacetime_tpu.utils.config import get_config

    info = device.require_gpu()
    card = device.card()
    print(f"# device: {info} | card: {card}", file=sys.stderr)

    eng = Engine(get_config("flagship_1080p"))
    cfg = eng.config
    print(f"# particles: {int(eng.particles.num_active())}, image: "
          f"{cfg.width}x{cfg.height}, history {cfg.history}", file=sys.stderr)

    # warm past the diagnostics adaptation (it may recompile at frames 30
    # and 60), compile included; the timed window (frames 100-135) ends
    # before the blobs collide (~frame 140), after which debris outgrows
    # the render budgets and the adaptation recompiles
    t0 = time.perf_counter()
    img = None
    for _ in range(100):
        img = eng.run_frame()
    jax.block_until_ready(img)
    print(f"# warmup+compile: {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    n_frames = 35
    t0 = time.perf_counter()
    for _ in range(n_frames):
        jax.block_until_ready(eng.run_frame())
    dt_frame = (time.perf_counter() - t0) / n_frames
    fps = 1.0 / dt_frame

    # physics-only steps/sec
    step = eng.model.step
    p2, _ = step(eng.particles)
    jax.block_until_ready(p2)
    n_steps = 100
    t0 = time.perf_counter()
    for _ in range(n_steps):
        p2, _ = step(p2)
    jax.block_until_ready(p2)
    sps = n_steps / (time.perf_counter() - t0)

    hlo = eng.frame_hlo()
    fn = eng._fused_frame_fn(eng._render_params())
    frame_cost = roofline.cost_of(fn.lower(
        eng.particles, eng.worldline, eng.camera, jnp.float32(eng.time),
    ).compile())
    rl = roofline.Roofline(
        flops=frame_cost[0], bytes_accessed=frame_cost[1],
        seconds=dt_frame, chip=roofline.chip_kind(),
    )

    def _run_traced():
        img = None
        for _ in range(5):
            img = eng.run_frame()
        jax.block_until_ready(img)

    meas = profiling.measured_roofline(_run_traced, 5, hlo)
    stage_ms = {k: round(v * 1e3, 3) for k, v in meas["stages"].items()}
    mrays = cfg.width * cfg.height * fps / 1e6
    print(
        f"# [{card}] fused frame: {dt_frame*1e3:.3f} ms ({fps:.1f} fps); "
        f"physics-only: {sps:.0f} steps/s; retarded render: "
        f"{mrays:.1f} Mrays/s; device busy {meas['device_s']*1e3:.3f} ms "
        f"of {meas['window_s']*1e3:.3f} ms traced per frame (idle share "
        f"{meas['idle_share']:.3f}); stages {stage_ms}",
        file=sys.stderr,
    )
    print(f"# [{card}] static-bound roofline: {rl.summary()}", file=sys.stderr)
    print(json.dumps({
        "metric": "flagship_1080p fused frame (10k particles, 1080p "
                  "retarded render)",
        "value": round(fps, 2),
        "unit": "fps",
        "vs_baseline": round(fps / PACING_FPS, 3),
        "frame_ms": round(dt_frame * 1e3, 3),
        "physics_steps_per_s": round(sps, 1),
        "device": info,
        "card": card,
        "device_busy_ms": round(meas["device_s"] * 1e3, 3),
        "idle_share": round(meas["idle_share"], 4),
        "stage_ms": stage_ms,
        "flops_per_frame": frame_cost[0],
        "bytes_per_frame_static": frame_cost[1],
        "flops_util_pct": round(100 * rl.flops_util, 3),
        "hbm_util_static_pct": round(100 * rl.hbm_util, 2),
    }))


def _scripted_keys(i: int):
    """Deterministic camera script: pan right, then zoom in, then pause at
    the end — enough input variety to exercise the hotswap/camera paths."""
    if i < 10:
        return {"d": True}
    if i < 20:
        return {"z": True}
    return None


def _perf_path(session: str) -> str:
    return session + ".perf.json"


def _run_session(eng, events_or_n, record_path=None):
    """Drive the engine (recording or replaying) and return the perf dict."""
    import numpy as _np

    from spacetime_tpu.utils import replay as replay_mod

    times = []
    eng.sync_per_frame = True  # honest per-frame pipelined timing

    if record_path is not None:
        rec = replay_mod.ReplayRecorder(
            record_path, config=eng.config,
            meta={"config_name": eng.config.name},
        )
        eng.recorder = rec
        for i in range(events_or_n):
            t0 = time.perf_counter()
            eng.run_frame(keys=_scripted_keys(i))
            times.append(time.perf_counter() - t0)
        rec.close()
    else:
        # canonical event interpretation lives in replay_events; time each
        # frame as the delta between successive on_frame callbacks
        t_last = [time.perf_counter()]

        def on_frame(i, img):
            now = time.perf_counter()
            times.append(now - t_last[0])
            t_last[0] = now

        replay_mod.replay_events(eng, events_or_n, on_frame=on_frame)
    jax.block_until_ready(eng._prev_img)
    # drop compile/adaptation warmup: steady state = last half
    steady = _np.asarray(times[len(times) // 2:])
    perf = {
        "frames": len(times),
        "frame_avg_ms": float(steady.mean() * 1e3),
        "fps_avg": float(1.0 / max(steady.mean(), 1e-9)),
        "low_1pct_ms": float(_np.sort(steady)[-max(1, len(steady) // 100):]
                             .mean() * 1e3),
        "config": eng.config.name,
        "backend": jax.default_backend(),
    }
    return perf


def _cmd_record(args):
    from spacetime_tpu.engine import Engine
    from spacetime_tpu.utils.config import get_config

    eng = Engine(get_config(args.config))
    perf = _run_session(eng, args.frames, record_path=args.record)
    with open(_perf_path(args.record), "w") as f:
        json.dump(perf, f, indent=2)
    print(json.dumps({
        "metric": f"recorded session {args.config}",
        "value": round(perf["fps_avg"], 2), "unit": "fps",
        "vs_baseline": round(perf["fps_avg"] / PACING_FPS, 3),
    }))


def _cmd_replay(args):
    from spacetime_tpu.engine import Engine
    from spacetime_tpu.utils import replay as replay_mod
    from spacetime_tpu.utils.config import get_config

    header, events = replay_mod.load_full(args.replay)
    name = (header.get("meta") or {}).get("config_name")
    if not name:
        raise SystemExit("session has no meta.config_name header")
    eng = Engine(get_config(name))
    fp = replay_mod.config_fingerprint(eng.config)
    if header.get("config") not in (None, fp):
        raise SystemExit("config fingerprint mismatch: the session was "
                         "recorded under a different EngineConfig")
    perf = _run_session(eng, events)
    with open(_perf_path(args.replay), "w") as f:
        json.dump(perf, f, indent=2)
    print(json.dumps({
        "metric": f"replayed session {name} ({perf['frames']} frames)",
        "value": round(perf["fps_avg"], 2), "unit": "fps",
        "vs_baseline": round(perf["fps_avg"] / PACING_FPS, 3),
    }))


def _cmd_diff(args):
    a = json.load(open(args.diff[0]))
    b = json.load(open(args.diff[1]))
    keys = ("frame_avg_ms", "fps_avg", "low_1pct_ms")
    deltas = {
        k: {
            "a": a.get(k), "b": b.get(k),
            "delta_pct": round(100.0 * (b[k] - a[k]) / a[k], 2)
            if a.get(k) and b.get(k) else None,
        }
        for k in keys
    }
    # regression = steady frame time worsened beyond noise; a missing
    # frame_avg_ms in either file is NOT a clean pass (a truncated/failed
    # run must not green-light a CI gate) — report unknown, exit 2
    d_frame = deltas["frame_avg_ms"]["delta_pct"]
    reg = "unknown" if d_frame is None else bool(d_frame > args.threshold)
    print(json.dumps({
        "a": args.diff[0], "b": args.diff[1],
        "config": {"a": a.get("config"), "b": b.get("config")},
        "deltas": deltas,
        "regression": reg,
        "threshold_pct": args.threshold,
    }, indent=2))
    if reg == "unknown":
        return 2
    return 1 if reg else 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--record", metavar="SESSION")
    ap.add_argument("--replay", metavar="SESSION")
    ap.add_argument("--diff", nargs=2, metavar=("A.perf.json", "B.perf.json"))
    ap.add_argument("--config", default="flagship_1080p")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--threshold", type=float, default=5.0,
                    help="regression threshold, pct frame-time increase")
    _args = ap.parse_args()
    if _args.record:
        _cmd_record(_args)
    elif _args.replay:
        _cmd_replay(_args)
    elif _args.diff:
        sys.exit(_cmd_diff(_args))
    else:
        main()
