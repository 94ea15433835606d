"""Side-by-side showcase: 3-band hat Doppler vs the physically-based
spectral (blackbody) model (RenderParams.spectral) on a fast-approaching /
receding blob pair.  Writes spectral_{hat,planck}.png plus a combined
strip into OUTDIR (default: the current directory).
Usage: JAX_PLATFORMS=cpu python tools/showcase_spectral.py [OUTDIR]
(CPU-sized scene)."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from spacetime_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

from spacetime_tpu import scene  # noqa: E402
from spacetime_tpu.camera import Camera  # noqa: E402
from spacetime_tpu.engine import save_png  # noqa: E402
from spacetime_tpu.models.softbody import SoftbodyModel  # noqa: E402
from spacetime_tpu.ops import raytrace  # noqa: E402
from spacetime_tpu.ops import worldline as wl  # noqa: E402


def main(outdir="."):
    w = h = 192
    sb = scene.SceneBuilder()
    # one blob rushing at the camera, one rushing away: max Doppler contrast
    sb.add(scene.disc_softbody(12, 0, (0.46, 0.50), (0.75, 0.0)),
           base_color=(0.85, 0.85, 0.85))
    sb.add(scene.disc_softbody(12, 1, (0.54, 0.50), (-0.75, 0.0)),
           base_color=(0.85, 0.85, 0.85))
    particles, objects = sb.build(capacity=2048)
    model = SoftbodyModel(capacity=2048)
    buf = wl.create(64, 2048)
    buf = wl.prefill_inertial(
        buf, particles.pos, particles.vel, particles.active,
        jnp.float32(0.0), jnp.float32(model.params.h),
    )
    buf = wl.push_frame(buf, particles, 0.0)
    cam = Camera.create(pos=(0.55, 0.55), zoom=0.3)
    base = raytrace.RenderParams(num_rays=512, ambient=0.0)
    base = dataclasses.replace(
        base, cell_px=raytrace.auto_cell_px(base, w, h, 0.3)
    )
    variants = {
        "hat": base,
        "planck": dataclasses.replace(base, spectral=True),
    }
    imgs = {}
    for name, p in variants.items():
        img = raytrace.render_retarded(
            buf, particles.object_index, objects, cam, w, h, p
        )
        imgs[name] = np.asarray(img)
        path = os.path.join(outdir, f"spectral_{name}.png")
        save_png(path, img)
        print(f"wrote {path} (min {imgs[name].min():.3f})")
    strip = np.concatenate([imgs["hat"], imgs["planck"]], axis=1)
    path = os.path.join(outdir, "spectral_side_by_side.png")
    save_png(path, jnp.asarray(strip))
    print(f"wrote {path} (left: 3-band hat, right: blackbody)")


if __name__ == "__main__":
    main(*sys.argv[1:2])
