"""Smoke test of the main path on a GPU, at the sizes users run.

Usage:
    python chip_smoke.py                   # one GPU: phases 1-6 below
    python chip_smoke.py --mesh 4          # four GPUs: the mesh phase only
    python chip_smoke.py --keep-trace DIR  # also keep the profiler trace
                                           # and the frame's HLO in DIR

Phases (any failure stops the script with a non-zero exit; nothing is
caught):
  1. the card-only tests (`pytest -m gpu`) in a child process that exits
     before this process opens the card (one JAX process per card);
  2. device: JAX's default device must be a GPU;
  3. compile the flagship_1080p fused frame through Engine (set-up time,
     memory_analysis);
  4. correctness on the card against the repo's plain references: the
     collision path vs the O(n^2) force oracle, the XLA pixel path vs
     render_retarded_brute, and the Triton pixel pass vs the XLA pass at
     full 1080p in both scenes;
  5. run: steady fused-frame time of flagship_1080p and of the 116k
     reference demo through Engine, every drop counter at 0, a profiler
     trace of the device busy/idle split, peak device memory;
  6. the pixel-pass decision timing: the whole fused frame with the XLA
     pass and with the Triton pass, in turns (XLA, Triton, Triton, XLA).

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from spacetime_tpu.utils import device  # noqa: E402
from spacetime_tpu.utils.cache import enable_compilation_cache  # noqa: E402

WARM = 100  # the diagnostics adaptation may recompile at frames 30 and 60
# frames timed after the warm-up.  The flagship's two blobs collide at
# ~frame 140; from then on debris outruns every render budget (band,
# bins), so its steady window ends before that.
TIMED = {"flagship_1080p": 35, "reference_demo": 50}
TURN = {"flagship_1080p": 15, "reference_demo": 25}  # decision-timing turns
XRAY_TOL = 0.01  # tests/test_render.py: fraction of pixels off by > 1e-3
OPAQUE_TOL = 0.03  # retina quantization moves shadow edges
PASS_TOL = 0.001  # Triton vs XLA pass: pixels off by > 1e-3 ...
PASS_REST = 1e-4  # ... and the rest within this


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")
    say(f"  ok: {what}")


def mismatch(a, b):
    """(fraction of pixels whose largest channel difference is > 1e-3,
    largest difference among the other pixels)."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    d = d.max(axis=-1)
    near = d[d <= 1e-3]
    return float((d > 1e-3).mean()), float(near.max() if near.size else 0.0)


def card_tests() -> None:
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
         "-p", "no:cacheprovider"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900,
    )
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-5:]
    for line in tail:
        say(f"  | {line}")
    check(proc.returncode == 0,
          f"card-only tests pass (pytest -m gpu, rc {proc.returncode}, "
          f"{time.perf_counter() - t0:.1f} s)")


def counters(eng) -> dict:
    import jax

    aux, diag = jax.device_get((eng.last_aux, eng.last_diag))
    out = {"grid_overflow": int(aux.grid_overflow)}
    for f in ("band_truncated", "bin_dropped", "entry_dropped",
              "retina_dropped", "segment_dropped"):
        v = getattr(diag, f)
        out[f] = 0 if v is None else int(v)
    out["cell_too_small"] = int(bool(diag.cell_too_small))
    return out


def warm(eng, n: int) -> None:
    import jax

    img = None
    for _ in range(n):
        img = eng.run_frame()
    jax.block_until_ready(img)


def adapt_state(eng):
    return eng.model, tuple(getattr(eng, f) for f in eng._ADAPT_FIELDS)


def timed_frames(eng, n: int):
    """Per-frame ms of `n` fused frames, each ending in block_until_ready,
    and every drop counter summed over those frames (read after each
    frame, outside its timing)."""
    import jax

    ms, total = [], {}
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(eng.run_frame())
        ms.append((time.perf_counter() - t0) * 1e3)
        for k, v in counters(eng).items():
            total[k] = total.get(k, 0) + v
    return np.asarray(ms), total


def engine_for(name: str, backend: str):
    from spacetime_tpu.engine import Engine
    from spacetime_tpu.utils.config import get_config

    cfg = get_config(name)
    cfg = dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, backend=backend))
    return Engine(cfg)


def run_cell(eng, tag: str) -> None:
    """Warm-up, then the steady window: no adaptation recompile inside it
    and every counter 0 on every frame of it."""
    name = eng.config.name
    t0 = time.perf_counter()
    warm(eng, WARM)
    say(f"{tag} {name}: {int(eng.particles.num_active())} particles, "
        f"{WARM} warm-up frames (compiles and adaptation incl.) "
        f"{time.perf_counter() - t0:.1f} s")
    before = adapt_state(eng)
    ms, total = timed_frames(eng, TIMED[name])
    say(f"{tag} {name} steady fused frame, frames {WARM}-{eng.frame}: mean "
        f"{ms.mean():.3f} ms, median {float(np.median(ms)):.3f} ms "
        f"({1e3 / ms.mean():.1f} fps); counters summed over the window "
        f"{total}")
    check(adapt_state(eng) == before,
          f"{name}: no adaptation recompile inside the timed window")
    check(all(v == 0 for v in total.values()),
          f"{name}: every drop counter 0 on every timed frame")


def physics_check(eng, tag: str) -> None:
    """The collision path's forces (dense cell table) vs the O(n^2) oracle
    at the engine's current state (tests/test_cell_table.py bounds)."""
    import jax

    from spacetime_tpu.ops import forces, grid

    p, m = eng.particles, eng.model
    rest = p.rest_len if p.rest_len is not None else m.rest_lengths()

    @jax.jit
    def cells(pos, active, nbr, rest):
        t = grid.build_cell_table(pos, active, m.params.grid_resolution,
                                  m.grid_dim, m.cell_capacity)
        ncell = grid.neighbor_cells(t, m.grid_dim)
        f = forces.total_forces_cells(pos, nbr, t, ncell, t.idx_rows[ncell],
                                      rest, m.params)
        return f, t.overflow

    f_cells, overflow = cells(p.pos, p.active, p.neighbors, rest)
    f_dense = jax.jit(forces.total_forces_dense, static_argnums=4)(
        p.pos, p.neighbors, p.active, rest, m.params)
    act = np.asarray(p.active)
    a, b = np.asarray(f_cells)[act], np.asarray(f_dense)[act]
    say(f"{tag} physics at frame {eng.frame}: {int(act.sum())} active of "
        f"{p.capacity}; max |f| {np.abs(b).max():.4g}, max |cells - dense| "
        f"{np.abs(a - b).max():.4g}")
    check(int(overflow) == 0, "cell table grid_overflow == 0")
    check(bool(np.allclose(a, b, rtol=1e-4, atol=1e-3)),
          "cell-path forces == O(n^2) oracle (rtol 1e-4, atol 1e-3, "
          "active particles)")


def render_vs_brute(eng, tag: str, width=192, height=108) -> None:
    """The XLA pixel path vs render_retarded_brute on the engine's state,
    same camera, reduced image size (tests/test_render.py bounds)."""
    import jax

    from spacetime_tpu.ops import raytrace as rt

    # the whole ring, no pair/entry budgets (at this image size every pair
    # splats into more, smaller cells than the 1080p budgets assume) and
    # the engine's band ceiling (12): the brute renderer sees every tick,
    # so this compares the pass itself, with nothing dropped
    base = dataclasses.replace(eng.config.render, backend="xla", max_age=0,
                               pair_budget=0, entry_budget=0, band=12)
    base = dataclasses.replace(base, cell_px=rt.auto_cell_px(
        base, width, height, float(eng.camera.zoom)))
    args = (eng.worldline, eng.particles.object_index, eng.objects,
            eng.camera, width, height)
    for opaque, tol in ((False, XRAY_TOL), (True, OPAQUE_TOL)):
        params = dataclasses.replace(base, opaque=opaque)
        brute = rt.render_retarded_brute(*args, params, pixel_chunk=16)
        fast, diag = rt.render_retarded_with_diag(*args, params)
        diag = jax.device_get(diag)
        frac, _ = mismatch(brute, fast)
        kind = "opaque" if opaque else "x-ray"
        say(f"{tag} {kind} {width}x{height} (cell_px {params.cell_px}) vs "
            f"brute: {frac:.4%} of pixels differ by > 1e-3; diag {diag}")
        check((brute < 0.999).any(), f"{kind} brute image is not blank")
        check(int(diag.bin_dropped) == 0 and int(diag.band_truncated) == 0,
              f"{kind} XLA pass dropped nothing (bin_dropped, "
              f"band_truncated 0)")
        check(frac < tol, f"{kind} XLA pass vs brute: < {tol:.0%} of pixels "
                          f"differ by > 1e-3")


def passes_agree(eng, tag: str) -> None:
    """Triton pixel pass vs XLA pass on the engine's state at full size."""
    from spacetime_tpu.ops import raytrace as rt
    from spacetime_tpu.ops import worldline as wl

    cfg = eng.config
    params = eng._render_params()
    imgs = {}
    for backend in ("xla", "triton"):
        img, diag = rt.render_retarded_with_diag(
            eng.worldline, eng.particles.object_index, eng.objects,
            eng.camera, cfg.width, cfg.height,
            dataclasses.replace(params, backend=backend),
            boundary=wl.boundary_mask(eng.particles),
        )
        imgs[backend] = img
    frac, rest = mismatch(imgs["xla"], imgs["triton"])
    say(f"{tag} {cfg.name} {cfg.width}x{cfg.height} Triton vs XLA pass: "
        f"{frac:.5%} of pixels differ by > 1e-3, the rest by <= {rest:.3g}")
    check(frac < PASS_TOL and rest <= PASS_REST,
          f"Triton pass == XLA pass (< {PASS_TOL:.1%} of pixels off by "
          f"> 1e-3, the rest within {PASS_REST:g})")


def trace_frames(eng, tag: str, keep: str | None) -> None:
    import jax

    from spacetime_tpu.utils import profiling

    hlo = eng.frame_hlo()
    d = keep or tempfile.mkdtemp(prefix="chip_smoke_trace_")
    os.makedirs(d, exist_ok=True)
    n = 5

    def run():
        img = None
        for _ in range(n):
            img = eng.run_frame()
        jax.block_until_ready(img)

    with profiling.trace(d):
        run()
    tot = profiling.measured_totals(d, n)
    stages = profiling.parse_stage_durations(d, n, hlo)
    if keep:
        with open(os.path.join(d, "frame.hlo.txt"), "w") as f:
            f.write(hlo)
    else:
        shutil.rmtree(d)
    say(f"{tag} {eng.config.name} trace of {n} frames: device busy "
        f"{tot['device_s'] * 1e3:.3f} ms/frame of a "
        f"{tot['window_s'] * 1e3:.3f} ms window (idle share "
        f"{tot['idle_share']:.3f}); stages ms/frame "
        + json.dumps({k: round(v * 1e3, 3) for k, v in stages.items()}))


def single_card(args) -> dict:
    import jax
    import jax.numpy as jnp
    from spacetime_tpu import paths

    say("phase 1: card-only tests")
    card_tests()

    say("phase 2: device")
    info = device.require_gpu()
    card = device.card()
    tag = f"[{card}]"
    say(f"{tag} platform {info['platform']}, kind {info['kind']}, "
        f"{info['count']} device(s); pixel path {paths.for_platform().pixel}")

    say("phase 3: compile the flagship_1080p fused frame")
    eng = engine_for("flagship_1080p", "auto")
    cfg = eng.config
    say(f"{tag} flagship_1080p: {int(eng.particles.num_active())} particles "
        f"(capacity {eng.particles.capacity}), {cfg.width}x{cfg.height}, "
        f"history {cfg.history}")
    fn = eng._fused_frame_fn(eng._render_params())
    t0 = time.perf_counter()
    compiled = fn.lower(eng.particles, eng.worldline, eng.camera,
                        jnp.float32(eng.time)).compile()
    say(f"{tag} compile (set-up): {time.perf_counter() - t0:.1f} s")
    say(f"{tag} memory_analysis: {compiled.memory_analysis()}")
    hlo = compiled.as_text()
    n_dot = hlo.count(" dot(") + hlo.count(" convolution(")
    n_triton = hlo.count("__gpu$xla.gpu.triton")
    say(f"{tag} fused frame HLO: {n_dot} matrix products (TF32 cannot "
        f"enter), {n_triton} Triton kernel call(s)")
    check(n_dot == 0, "no matrix product on the main path")
    check(n_triton >= 1, "the fused frame calls the Triton pixel pass")

    say("phase 5a: run flagship_1080p through Engine")
    run_cell(eng, tag)
    trace_frames(eng, tag, args.keep_trace)

    say("phase 4: correctness against the plain references")
    physics_check(eng, tag)
    render_vs_brute(eng, tag)
    passes_agree(eng, tag)

    say("phase 5b: run the 116k reference demo through Engine")
    ref = engine_for("reference_demo", "auto")
    run_cell(ref, tag)
    passes_agree(ref, tag)
    del ref

    say("phase 6: pixel-pass decision, whole fused frame in turns")
    for name in ("flagship_1080p", "reference_demo"):
        # fresh engines at the same scene epoch; each turn covers the next
        # TURN frames of its engine, with no recompile and no drop inside
        engines = {b: engine_for(name, b) for b in ("xla", "triton")}
        for e in engines.values():
            warm(e, WARM)
        before = {b: adapt_state(e) for b, e in engines.items()}
        times, dropped = [], 0
        for b in ("xla", "triton", "triton", "xla"):
            ms, total = timed_frames(engines[b], TURN[name])
            times.append(f"{b} {float(np.median(ms)):.3f}")
            dropped += sum(total.values())
        say(f"{tag} {name} fused frame median ms per turn (frames "
            f"{WARM}-{WARM + 2 * TURN[name]}): " + ", ".join(times))
        check(all(adapt_state(e) == before[b] for b, e in engines.items()),
              f"{name}: no recompile inside the turns")
        check(dropped == 0, f"{name}: every drop counter 0 in the turns")
        del engines

    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    say(f"{tag} peak_bytes_in_use: {peak}")
    return info


def mesh_phase(args) -> dict:
    """The mesh-native Engine on `args.mesh` cards vs the same engine on
    one card, from the same start state."""
    import jax

    from spacetime_tpu.engine import Engine
    from spacetime_tpu.parallel import mesh as mesh_mod
    from spacetime_tpu.utils.config import get_config

    info = device.require_gpu()
    card = device.card()
    tag = f"[{card}]"
    say(f"{tag} platform {info['platform']}, kind {info['kind']}, "
        f"{info['count']} device(s)")
    check(info["count"] >= args.mesh, f"at least {args.mesh} GPUs")
    cfg = get_config("flagship_1080p")
    single = Engine(cfg)
    multi = Engine(cfg, mesh=mesh_mod.make_mesh(args.mesh))
    n = 3
    for _ in range(n):
        img1 = single.run_frame()
        img2 = multi.run_frame()
    jax.block_until_ready((img1, img2))
    hlo = multi.frame_hlo()
    n_custom = hlo.count("custom_call_target=")
    n_triton = hlo.count("__gpu$xla.gpu.triton")
    say(f"{tag} mesh frame HLO: {n_custom} custom call(s), {n_triton} "
        f"Triton kernel call(s)")
    check(n_triton == 0, "no unsharded kernel call in the partitioned frame")
    for name, arr in (("particles", multi.particles.pos),
                      ("ring", multi.worldline.pos_x)):
        got = len(arr.sharding.device_set)
        check(got == args.mesh, f"{name} spread over {got} devices")
    frac, rest = mismatch(img1, img2)
    act = np.asarray(single.particles.active)
    p1 = np.asarray(single.particles.pos)[act]
    p2 = np.asarray(multi.particles.pos)[act]
    say(f"{tag} after {n} frames: {frac:.5%} of pixels differ by > 1e-3 "
        f"(rest <= {rest:.3g}); max |dpos| {np.abs(p1 - p2).max():.3g}")
    check(frac < PASS_TOL and rest <= PASS_REST,
          "mesh image == single-card image (render tolerance)")
    check(bool(np.allclose(p1, p2, rtol=1e-5, atol=1e-6)),
          "mesh particle state == single-card state (allclose)")
    t_single, _ = timed_frames(single, 20)
    t_multi, _ = timed_frames(multi, 20)
    say(f"{tag} fused frame median ms: single card "
        f"{float(np.median(t_single)):.3f}, {args.mesh}-card mesh "
        f"{float(np.median(t_multi)):.3f}")
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", type=int, default=0,
                    help="run only the mesh phase on this many GPUs")
    ap.add_argument("--keep-trace", default=None, metavar="DIR",
                    help="keep the profiler trace and frame HLO here")
    args = ap.parse_args(argv)
    say(device.card())
    enable_compilation_cache()
    info = mesh_phase(args) if args.mesh else single_card(args)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
