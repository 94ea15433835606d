"""Device mesh helpers."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: Optional[int] = None, axis: str = "d") -> Mesh:
    """1D mesh over the first n devices (particles and pixels shard over one
    axis; the cards of one host are joined all to all, so a 1-D mesh loses
    nothing to topology)."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n_devices]), (axis,))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
