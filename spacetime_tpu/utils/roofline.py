"""Roofline accounting for compiled XLA programs.

The reference instruments per-stage GPU time (reference: src/querybank.rs)
but never anchors it to hardware capability.  Here a bench row carries its
achieved FLOP/s and memory bandwidth as fractions of the card's published
peaks, from `compiled.cost_analysis()` (XLA's static per-program cost model)
divided by a measured time.

This workload is f32 vector math (no matrix products on the main path), so
the compute peak is the card's f32 rate outside the tensor cores.  XLA's
"bytes accessed" counts every operand of every fused op, including data a
fusion keeps on chip, so it is an UPPER bound on memory traffic; trace-
derived kernel times (utils/profiling.py) remain the ground truth.
"""

from __future__ import annotations

from typing import NamedTuple

import jax


class Peak(NamedTuple):
    flops_f32: float  # FLOP/s, f32 outside the tensor cores
    hbm_Bps: float  # device-memory bytes/s
    source: str


# keyed by jax.devices()[0].device_kind.  A device missing here is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peak(
        flops_f32=67e12, hbm_Bps=3.35e12,
        source="NVIDIA H100 Tensor Core GPU datasheet, SXM: 67 TFLOP/s FP32, "
               "3.35 TB/s HBM3 (at the 700 W power limit)",
    ),
}


def peak_for(device_kind: str) -> Peak:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r} "
            f"(known: {sorted(PEAKS)})"
        ) from None


def chip_kind() -> str:
    """device_kind of jax.devices()[0] (the key of PEAKS)."""
    return jax.devices()[0].device_kind


class Roofline(NamedTuple):
    flops: float  # algorithmic FLOPs per program execution (XLA count)
    bytes_accessed: float  # memory bytes per execution (XLA count)
    seconds: float  # measured time per execution
    chip: str  # device_kind

    @property
    def achieved_flops(self) -> float:
        return self.flops / self.seconds if self.seconds else 0.0

    @property
    def achieved_Bps(self) -> float:
        return self.bytes_accessed / self.seconds if self.seconds else 0.0

    @property
    def flops_util(self) -> float:
        """Fraction of the card's f32 peak."""
        return self.achieved_flops / peak_for(self.chip).flops_f32

    @property
    def hbm_util(self) -> float:
        return self.achieved_Bps / peak_for(self.chip).hbm_Bps

    @property
    def bound(self) -> str:
        """Which peak bounds the least possible time: 'memory' or 'compute'."""
        pk = peak_for(self.chip)
        return ("memory" if self.bytes_accessed / pk.hbm_Bps
                >= self.flops / pk.flops_f32 else "compute")

    def summary(self) -> str:
        return (
            f"{self.flops/1e9:.2f} GFLOP, {self.bytes_accessed/1e9:.2f} GB "
            f"per frame | achieved {self.achieved_flops/1e12:.3f} TFLOP/s "
            f"({100*self.flops_util:.2f}% of the {self.chip} f32 peak), "
            f"{self.achieved_Bps/1e9:.0f} GB/s ({100*self.hbm_util:.1f}% of "
            f"peak; static-count bytes, an upper bound), {self.bound}-bound"
        )


def cost_of(compiled) -> tuple[float, float]:
    """(flops, bytes_accessed) from a compiled function's cost analysis."""
    ca = compiled.cost_analysis()
    return float(ca.get("flops", 0.0)), float(ca.get("bytes accessed", 0.0))


def measure(jitted_fn, args, seconds: float) -> Roofline:
    """Roofline stats for a jitted function already traced with `args`
    (AOT-lowered here; reuses the compilation cache) at measured `seconds`
    per execution."""
    compiled = jitted_fn.lower(*args).compile()
    flops, by = cost_of(compiled)
    return Roofline(flops=flops, bytes_accessed=by, seconds=seconds,
                    chip=chip_kind())
