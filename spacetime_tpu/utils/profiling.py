"""Device-level profiling hooks.

The reference brackets GPU work with timestamp queries
(reference: src/querybank.rs, boilerplate.rs:210-240).  The equivalents here:

  * `trace(logdir)` — capture a jax.profiler trace (XLA op-level timeline,
    viewable in TensorBoard/Perfetto) around a block of frames.
  * `annotate(name)` — named TraceAnnotation so engine stages (step /
    worldline / render) show up as spans inside the trace.
  * `device_memory_stats()` — device memory snapshot (peak/current).
  * `measured_totals(logdir, n)` — device busy time, kernel time and idle
    share of a traced window.
  * `stage_breakdown(run, n_frames, hlo_text)` — per-stage device time of
    the FUSED frame program: captures a trace around `run()` and attributes
    every device kernel to step / worldline / render by the jitted-function
    path of the op it ran.  This measures the SAME program the engine
    executes — unlike config.stage_timing, which re-times a split
    3-dispatch variant.

Reading a GPU trace.  Device kernels are the complete ("X") events on the
processes named "/device:GPU:<n>".  A kernel launched on its own carries its
op path in `args.name` ("jit(frame)/jit(render_retarded_with_diag)/sort");
XLA also replays runs of kernels as CUDA graphs ("command buffers"), and
those events carry only the kernel name — the fusion's HLO instruction name
— so the path comes from the compiled module's op metadata (`hlo_text`).
On the CPU backend the op events sit on host threads and carry only their
HLO instruction name (`args.hlo_op`), named the same way.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import re
import tempfile
from typing import Dict, List, Optional

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profiler trace for the enclosed block."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span inside a profiler trace (and in Python profilers)."""
    return jax.profiler.TraceAnnotation(name)


# op-path fragments -> stage names (order matters: first match wins).
# The fused frame's ops carry paths like "jit(frame)/jit(step)/gather" or
# "jit(frame)/jit(render_retarded_with_diag)/sort".
_STAGE_PATTERNS = (
    ("jit(step)", "step"),
    ("physics_step", "step"),
    ("jit(push_raw)", "worldline"),
    ("push_frame", "worldline"),
    ("render_retarded", "render"),
    ("render_btz", "render"),
    ("_render_btz_impl", "render"),
    ("render_conical", "render"),
    ("_render_conical_impl", "render"),
    ("render_retina", "render"),
    ("render_points", "render"),
    ("render_worldline3d", "render"),
    ("pixel_pass", "render"),
)


def _classify(path: str) -> str:
    for frag, stage in _STAGE_PATTERNS:
        if frag in path:
            return stage
    return "other"


def _newest_trace(logdir: str) -> dict:
    files = sorted(glob.glob(f"{logdir}/**/*.trace.json.gz", recursive=True))
    if not files:
        raise RuntimeError(f"no profiler trace under {logdir!r}")
    with gzip.open(files[-1], "rt") as f:
        return json.load(f)


def device_events(data: dict) -> List[dict]:
    """The device-op events of a loaded trace: every complete event on a
    "/device:..." process (GPU), or, where there is none (the CPU backend),
    the host-thread events of compiled HLO ops (`args.hlo_op`)."""
    device_pids = {
        e["pid"] for e in data.get("traceEvents", [])
        if e.get("ph") == "M" and e.get("name") == "process_name"
        and str((e.get("args") or {}).get("name", "")).startswith("/device:")
    }
    events = data.get("traceEvents", [])
    if device_pids:
        return [e for e in events
                if e.get("ph") == "X" and e.get("pid") in device_pids]
    return [
        e for e in events
        if e.get("ph") == "X" and "hlo_op" in (e.get("args") or {})
    ]


def _busy_us(events: List[dict]) -> float:
    """Length of the union of the events' [ts, ts + dur) intervals."""
    busy, end = 0.0, None
    for ts, dur in sorted((e["ts"], e.get("dur", 0.0)) for e in events):
        stop = ts + dur
        if end is None or ts >= end:
            busy += dur
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy


def measured_totals(logdir: str, n_iters: int) -> Dict[str, float]:
    """Per-iteration device numbers from the newest trace under `logdir`:
    `device_s` (busy: the union of kernel intervals), `kernel_s` (sum of
    kernel durations; above busy when kernels overlap), `window_s` (first
    kernel start to last kernel end) and `idle_share` (1 - busy/window).
    Raises when the trace holds no device kernels."""
    events = device_events(_newest_trace(logdir))
    if not events:
        raise RuntimeError(f"trace under {logdir!r} holds no device kernels")
    busy = _busy_us(events)
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e.get("dur", 0.0) for e in events)
    window = max(t1 - t0, 1e-9)
    return {
        "device_s": busy / n_iters / 1e6,
        "kernel_s": sum(e.get("dur", 0.0) for e in events) / n_iters / 1e6,
        "window_s": window / n_iters / 1e6,
        "idle_share": 1.0 - busy / window,
    }


_HLO_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name=\"([^\"]*)\"")


def _kernel_key(name: str) -> str:
    """GPU kernels are named after their HLO instruction with '.' and '-'
    as '_' ("input_reduce_fusion.5" -> "input_reduce_fusion_5"); one
    instruction lowered to several kernels adds "__<n>" ("sort_0_1__2")."""
    return re.sub(r"__\d+$", "", name.replace(".", "_").replace("-", "_"))


def hlo_op_paths(hlo_text: str) -> Dict[str, str]:
    """Kernel key (see _kernel_key) -> op path (metadata op_name) for every
    instruction of a compiled module's text (`compiled.as_text()`)."""
    out = {}
    for line in hlo_text.splitlines():
        m = _HLO_INSTR.match(line)
        if m:
            out[_kernel_key(m.group(1))] = m.group(2)
    return out


def _op_path(e: dict, paths: Dict[str, str]) -> str:
    """Everything that names the op an event ran: its own op path, the op
    path of its HLO instruction, and the kernel name (a Pallas kernel's
    name, e.g. "pixel_pass")."""
    args = e.get("args") or {}
    name = e.get("name", "")
    return " ".join(filter(None, (
        args.get("name"), paths.get(_kernel_key(name)),
        paths.get(_kernel_key(args.get("hlo_op", ""))), name,
    )))


def parse_stage_durations(logdir: str, n_frames: int,
                          hlo_text: Optional[str] = None) -> Dict[str, float]:
    """Device seconds per frame per stage from the newest trace under
    `logdir`, plus 'total' (all device kernel time).  `hlo_text` (the
    compiled frame's HLO) names kernels replayed inside CUDA graphs.
    Kernels whose op path is unknown count under 'other'.  Raises when the
    trace holds no device kernels, or when no kernel could be attributed to
    a stage (the reduction no longer reads this trace format)."""
    events = device_events(_newest_trace(logdir))
    if not events:
        raise RuntimeError(f"trace under {logdir!r} holds no device kernels")
    paths = hlo_op_paths(hlo_text) if hlo_text else {}
    sums: Dict[str, float] = {}
    for e in events:
        stage = _classify(_op_path(e, paths))
        sums[stage] = sums.get(stage, 0.0) + e.get("dur", 0.0)
    if set(sums) == {"other"}:
        raise RuntimeError(
            f"no kernel of the trace under {logdir!r} was attributed to a "
            f"stage ({len(events)} kernels, all 'other')"
        )
    out = {k: v / n_frames / 1e6 for k, v in sums.items()}  # us -> s
    out["total"] = sum(out.values())
    return out


def stage_breakdown(run, n_frames: int, hlo_text: Optional[str] = None,
                    logdir: Optional[str] = None) -> Dict[str, float]:
    """Per-stage device seconds/frame for whatever `run()` executes
    (expected: `n_frames` fused frames).  The caller must block on the
    result inside `run` so the trace contains the full device work."""
    if logdir is None:
        with tempfile.TemporaryDirectory(prefix="spacetime_prof_") as d:
            with trace(d):
                run()
            return parse_stage_durations(d, n_frames, hlo_text)
    with trace(logdir):
        run()
    return parse_stage_durations(logdir, n_frames, hlo_text)


def measured_roofline(run, n_frames: int, hlo_text: Optional[str] = None
                      ) -> Dict[str, float]:
    """Capture a trace around `run()` (which must execute and block on
    `n_frames` iterations) and return measured_totals + the per-stage
    device-time split."""
    with tempfile.TemporaryDirectory(prefix="spacetime_meas_") as d:
        with trace(d):
            run()
        out = measured_totals(d, n_frames)
        out["stages"] = parse_stage_durations(d, n_frames, hlo_text)
    return out


def device_memory_stats(device=None) -> Dict[str, int]:
    """Bytes in use / peak / limit for one device (empty if unsupported)."""
    dev = device or jax.devices()[0]
    stats = getattr(dev, "memory_stats", lambda: None)()
    if not stats:
        return {}
    keep = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
    return {k: int(v) for k, v in stats.items() if k in keep}
