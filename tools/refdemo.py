"""Shared builder for the reference's default demo scene: testimg4 at the
origin with velocity (0.1, 0.1), testimg5 at (1.2, 0.8) with (-0.1, -0.1)
(/root/reference/src/twoplusone/mod.rs:86-113), loaded through the PNG import
path.  Falls back to procedural discs of the same particle count when the
reference images are not mounted — the `reference_demo` named config builds
the same discs through the engine.  Used by tools/bench_116k.py."""

import os
import sys

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from spacetime_tpu import scene  # noqa: E402
from spacetime_tpu.camera import Camera  # noqa: E402
from spacetime_tpu.models.softbody import SoftbodyModel  # noqa: E402
from spacetime_tpu.ops import forces as forces_ops  # noqa: E402
from spacetime_tpu.ops import raytrace  # noqa: E402
from spacetime_tpu.ops import worldline as wl  # noqa: E402

REF_IMAGES = "/root/reference/softbodyimages"
WIDTH, HEIGHT = 1920, 1080


def build_scene():
    """The reference demo scene -> (particles, objects)."""
    sb = scene.SceneBuilder()
    if os.path.isdir(REF_IMAGES):
        sb.add(
            scene.image_to_softbody(
                f"{REF_IMAGES}/testimg4.png", 0, (0.0, 0.0), (0.1, 0.1),
                lattice_pad=True),
            base_color=(0.25, 0.35, 1.0),
        )
        sb.add(
            scene.image_to_softbody(
                f"{REF_IMAGES}/testimg5.png", 1, (1.2, 0.8), (-0.1, -0.1),
                lattice_pad=True),
            base_color=(1.0, 0.3, 0.25),
        )
    else:
        n_half = 57980  # testimg4/5 non-black pixel count
        sb.add(
            scene.disc_softbody(scene.radius_for_count(n_half), 0,
                                (0.0, 0.0), (0.1, 0.1), lattice_pad=True),
            base_color=(0.25, 0.35, 1.0),
        )
        sb.add(
            scene.disc_softbody(scene.radius_for_count(n_half), 1,
                                (1.2, 0.8), (-0.1, -0.1), lattice_pad=True),
            base_color=(1.0, 0.3, 0.25),
        )
    return sb.build()


def render_params(h):
    """The reference_demo config's render budgets (utils/config.py) at the
    ladder's cell_px=16 for this zoom, with the view-derived sweep bound the
    engine would pick (view corner 230 ticks + band + 8, rounded up)."""
    import dataclasses

    from spacetime_tpu.utils.config import get_config

    return dataclasses.replace(
        get_config("reference_demo").render, dt=h, cell_px=16, max_age=256,
    )


def build(history=1024):
    """Returns (particles, objects, model, buf, cam, params)."""
    particles, objects = build_scene()
    model = SoftbodyModel(
        capacity=particles.capacity,
        spring_offsets=forces_ops.derive_spring_offsets(
            np.asarray(particles.neighbors)),
    )
    buf = wl.create(history, particles.capacity)
    buf = wl.prefill_inertial(
        buf, particles.pos, particles.vel, particles.active,
        jnp.float32(0.0), jnp.float32(model.params.h),
    )
    cam = Camera.create(pos=(0.6, 0.4), zoom=2.0)
    return particles, objects, model, buf, cam, render_params(model.params.h)
