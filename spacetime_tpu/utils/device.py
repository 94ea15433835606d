"""What the program runs on: the JAX device and, on a GPU, the card's name
and power limit as nvidia-smi reports them.  Every measurement prints these
beside its numbers, because a card set below its maximum power limit runs
slower under load."""

from __future__ import annotations

import subprocess
from typing import Dict

import jax


def card() -> str:
    """`name, power.limit` of the first card, from nvidia-smi (raises when
    nvidia-smi is missing or fails)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def describe() -> Dict[str, object]:
    """platform, device_kind and device count of jax.devices()."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> Dict[str, object]:
    """describe(), or SystemExit(1) when JAX's default device is not a GPU:
    a measurement taken anywhere else is not a measurement of the card."""
    info = describe()
    if info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {info['platform']!r} "
            f"({info['kind']}); this measurement needs the card"
        )
    return info
