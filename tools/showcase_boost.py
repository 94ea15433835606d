"""Camera-frame (boosted observer) showcase: the same scene state rendered
in the GROUND frame and in the moving camera's instantaneous rest frame
(ops/boost.py closed-form Lorentz warp).  The camera flies at 0.5c between
two static blobs: in the boosted view the blob ahead stretches away by
gamma*(1+v) and the one behind closes in by gamma*(1-v).
Usage: python tools/showcase_boost.py [outdir]"""

import dataclasses
import sys

import jax

sys.path.insert(0, ".")

from spacetime_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

from spacetime_tpu.engine import Engine, save_png  # noqa: E402
from spacetime_tpu.utils.config import get_config  # noqa: E402


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "assets/showcase"
    import os

    os.makedirs(outdir, exist_ok=True)
    eng = Engine(get_config("boosted_observer"))
    img = None
    for _ in range(180):  # fill the light cone with history
        img = eng.run_frame()
    save_png(f"{outdir}/boosted_camera_frame.png", img)
    # same engine state, ground-frame plot of the same past cone
    r = eng.config.render
    eng.config = dataclasses.replace(
        eng.config, render=dataclasses.replace(r, camera_frame=False)
    )
    save_png(f"{outdir}/boosted_ground_frame.png", eng.render())
    print(f"wrote {outdir}/boosted_{{camera,ground}}_frame.png", flush=True)


if __name__ == "__main__":
    main()
