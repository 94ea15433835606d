"""The one place that chooses which implementation runs on this machine.

Each platform maps to a physics path and a pixel path:

  * physics "xla": the dense cell-table collision path (ops/grid.py,
    forces.total_forces_cells) — the path tested against the O(n^2) oracle.
  * pixel "xla": the view-table block map in ops/raytrace.py (also the
    only path of the curved, BTZ and batched-view renderers);
    pixel "triton": the fused Pallas kernel in ops/pixel_triton.py.

A platform missing from the table is an error, never a fallback.  Pallas
interpret mode is not a path: only tests ask for it, explicitly
(RenderParams.triton_interpret).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax


class Paths(NamedTuple):
    physics: str
    pixel: str


_BY_PLATFORM = {
    "cpu": Paths(physics="xla", pixel="xla"),
    "gpu": Paths(physics="xla", pixel="triton"),
}


def _platform() -> str:
    return jax.devices()[0].platform


def for_platform(platform: Optional[str] = None) -> Paths:
    """Paths for `platform` (default: the platform of jax.devices()[0])."""
    if platform is None:
        platform = _platform()
    try:
        return _BY_PLATFORM[platform]
    except KeyError:
        raise RuntimeError(
            f"no implementation for platform {platform!r} "
            f"(supported: {', '.join(sorted(_BY_PLATFORM))})"
        ) from None


def pixel_path(backend: str) -> str:
    """Resolve RenderParams.backend: "auto" takes the platform's pixel path;
    "xla" and "triton" name one explicitly."""
    if backend == "auto":
        return for_platform().pixel
    if backend not in ("xla", "triton"):
        raise ValueError(f"unknown pixel backend {backend!r}")
    return backend
