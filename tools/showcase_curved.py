"""Render curved-spacetime showcase frames (README): conical-defect double
imaging and BTZ black-hole lensing.  Usage: python tools/showcase_curved.py"""

import dataclasses
import sys

import jax
import numpy as np

sys.path.insert(0, ".")

from spacetime_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

from spacetime_tpu.engine import Engine, save_png  # noqa: E402
from spacetime_tpu.utils.config import get_config  # noqa: E402


def run(name, frames, out, **over):
    cfg = get_config(name)
    if over:
        cfg = dataclasses.replace(cfg, **over)
    eng = Engine(cfg)
    img = None
    for _ in range(frames):
        img = eng.run_frame()
    save_png(out, img)
    print(f"{out}: {np.asarray(img).shape}", flush=True)


def main():
    # conical defect: two blobs passing at 0.6c around a deficit-1.2 mass —
    # lensed double images + occlusion shadows (frame the whole pass)
    run("conical_defect", 140, "assets/showcase_conical_defect.png",
        cam_pos=(0.5, 0.42), cam_zoom=1.5)
    # BTZ: the same scene around a black hole — time-delayed double images
    # and the black horizon disc.  NOTE: cam_pos is the OBSERVER's worldline,
    # not just view framing — keep it well outside r_h or every delay
    # diverges and the frame is empty
    run("btz_hole", 140, "assets/showcase_btz_hole.png",
        cam_pos=(0.5, 0.15), cam_zoom=1.6)
    # rotating BTZ: same scene, frame dragging splits the double images
    # asymmetrically (co-rotating route arrives earlier)
    run("btz_spinning", 140, "assets/showcase_btz_spinning.png",
        cam_pos=(0.5, 0.15), cam_zoom=1.6)
    # boundary echoes: routes reflected off the AdS conformal boundary add
    # delayed third/fourth images (run deep into the 768-tick history so
    # the ~230-450-tick bounce delays have stored worldline to sample)
    run("btz_reflected", 480, "assets/showcase_btz_reflected.png",
        cam_pos=(0.5, 0.15), cam_zoom=1.6)


if __name__ == "__main__":
    main()
