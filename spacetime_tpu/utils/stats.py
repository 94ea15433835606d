"""Frame/stage performance statistics.

The reference instruments frames with a 32-slot GPU timestamp query pool
bracketing RK4 / grid update / meshgen, and a debug UI showing frame-time
average, 1% low and 0.1% low over a 2000-sample window
(reference: src/querybank.rs:5-47, src/debugui.rs:44-51,64-83).

Equivalent here: host `time.perf_counter` around `block_until_ready`
boundaries (per-stage device timing needs jax.profiler traces; the headless
stage timer here measures stage wall time with an explicit sync, which is the
honest analog of a fence wait)."""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class FramePerfStats:
    """Per-frame stage durations, seconds — mirrors the reference's
    FramePerfStats {rk4_time, grid_update_time, meshgen_time}
    (querybank.rs:14-30) with renderer stages added."""

    step_time: float = 0.0  # physics (rk4 + grid, fused in one jit)
    worldline_time: float = 0.0  # ring-buffer push ("meshgen" analog)
    render_time: float = 0.0
    frame_time: float = 0.0


class StatsWindow:
    """Rolling frame-time statistics (debugui.rs:44-51: avg, 1% low, 0.1% low
    over the last `window` frames)."""

    def __init__(self, window: int = 2000):
        self.window = window
        self.samples: deque[float] = deque(maxlen=window)
        self.stage_sums: Dict[str, float] = {}
        self.frames = 0
        # profiler-derived per-frame device stage seconds (the fused path's
        # stage attribution, utils.profiling.stage_breakdown); when set,
        # summary() reports these instead of the (zero) host-timed splits
        self.profiled_stages: Dict[str, float] = {}

    def add(self, stats: FramePerfStats) -> None:
        self.samples.append(stats.frame_time)
        self.frames += 1
        for k in ("step_time", "worldline_time", "render_time"):
            self.stage_sums[k] = self.stage_sums.get(k, 0.0) + getattr(stats, k)

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        arr = np.sort(np.asarray(self.samples))
        n = len(arr)
        worst_1pct = arr[-max(1, n // 100):]
        worst_01pct = arr[-max(1, n // 1000):]
        out = {
            "frame_avg_ms": float(arr.mean() * 1e3),
            "frame_last_ms": float(self.samples[-1] * 1e3),
            "low_1pct_ms": float(worst_1pct.mean() * 1e3),
            "low_01pct_ms": float(worst_01pct.mean() * 1e3),
            "fps_avg": float(1.0 / max(arr.mean(), 1e-9)),
        }
        for k, v in self.stage_sums.items():
            out[f"{k.removesuffix('_time')}_avg_ms"] = float(v / max(self.frames, 1) * 1e3)
        if self.profiled_stages:
            # fused-path stage attribution from a profiler capture of the
            # SAME compiled program (Engine.profile_stages)
            for k in ("step", "worldline", "render", "other", "total"):
                if k in self.profiled_stages:
                    out[f"{k}_dev_ms"] = float(self.profiled_stages[k] * 1e3)
            out["stage_source"] = "profiler"
        return out


class StageTimer:
    """Context-manager timer for one named stage."""

    def __init__(self):
        self.durations: Dict[str, float] = {}

    class _Ctx:
        def __init__(self, outer, name, sync):
            self.outer, self.name, self.sync = outer, name, sync

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            if self.sync is not None:
                import jax

                jax.block_until_ready(self.sync())
            self.outer.durations[self.name] = time.perf_counter() - self.t0

    def stage(self, name: str, sync=None) -> "_Ctx":
        return self._Ctx(self, name, sync)
