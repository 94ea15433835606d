"""Render the worldline-3D showcase frame (README): the (x, y, t) spacetime
block of a two-body collision seen side-on — the reference's worldline3d.glsl
intent (ops/worldline3d.py).  Usage: python tools/showcase_wl3d.py"""

import sys

import jax
import numpy as np

sys.path.insert(0, ".")

from spacetime_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

from spacetime_tpu.engine import Engine, save_png  # noqa: E402
from spacetime_tpu.utils.config import get_config  # noqa: E402


def main():
    # run deep enough that the worldlines braid through the impact; the
    # stock config collides at ~tick 180 — close the gap so a CPU render
    # finishes in minutes (accelerator runs use the config as-is)
    import dataclasses

    from spacetime_tpu.utils.config import SceneSpec, _blob, BLUE, RED

    cfg = get_config("worldline3d")
    cfg = dataclasses.replace(
        cfg,
        scene=SceneSpec(bodies=(
            _blob(2000, (0.38, 0.50), (0.2, 0.0), BLUE),
            _blob(2000, (0.62, 0.50), (-0.2, 0.0), RED),
        )),
    )
    eng = Engine(cfg)
    img = None
    for i in range(210):
        img = eng.run_frame()
        if i % 50 == 0:
            print(f"frame {i}", flush=True)
    save_png("assets/showcase_worldline3d.png", img)
    print(f"assets/showcase_worldline3d.png: {np.asarray(img).shape}",
          flush=True)


if __name__ == "__main__":
    main()
