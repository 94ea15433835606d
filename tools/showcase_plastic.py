"""Plastic-vs-elastic collision showcase (round-3 materials stretch): the
blue blob creeps (permanent dent), the red one is elastic.  Renders a
before / impact / after triptych.  Usage: python tools/showcase_plastic.py
[outdir]"""

import sys

import jax
import numpy as np

sys.path.insert(0, ".")

from spacetime_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

from spacetime_tpu.engine import Engine, save_png  # noqa: E402
from spacetime_tpu.utils.config import get_config  # noqa: E402


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "assets/showcase"
    import os

    os.makedirs(outdir, exist_ok=True)
    eng = Engine(get_config("plastic_collision"))
    checkpoints = {40: "plastic_before", 340: "plastic_impact",
                   640: "plastic_after"}
    img = None
    rest0 = float(np.nanmean(np.asarray(eng.particles.rest_len)[
        np.asarray(eng.particles.active)]))
    for i in range(1, max(checkpoints) + 1):
        img = eng.run_frame()
        if i in checkpoints:
            save_png(f"{outdir}/{checkpoints[i]}.png", img)
            rl = np.asarray(eng.particles.rest_len)
            act = np.asarray(eng.particles.active)
            obj = np.asarray(eng.particles.object_index)
            crept = float(np.mean(rl[act & (obj == 0)])) / rest0 - 1.0
            print(f"frame {i}: {checkpoints[i]} mean blue-bond creep "
                  f"{100*crept:.2f}%", flush=True)


if __name__ == "__main__":
    main()
