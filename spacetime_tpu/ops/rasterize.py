"""Non-relativistic point renderer: the reference's shipped debug view.

Draws every particle as a single pixel straight from the physics state, camera
pan+zoom, colored by object — "measured reality" with no light-travel delay
(reference: src/twoplusone/softbody/point_render_nr.rs:32-91,
points_norel.glsl:1-52; clear color white per boilerplate.rs render pass).

A scatter into an (H, W, 3) image instead of a point-list
graphics pipeline.  Last-write-wins on overlapping pixels, like unordered
point rasterization.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..camera import Camera, world_to_pixel
from ..state import Objects, Particles


@partial(jax.jit, static_argnames=("width", "height"))
def render_points(
    particles: Particles,
    objects: Objects,
    cam: Camera,
    width: int = 1280,
    height: int = 720,
) -> jax.Array:
    """(H, W, 3) f32 image in [0, 1], white background."""
    px = world_to_pixel(particles.pos, width, height, cam)
    xi = jnp.round(px[:, 0]).astype(jnp.int32)
    yi = jnp.round(px[:, 1]).astype(jnp.int32)
    inside = (
        particles.active & (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
    )
    # Out-of-view points scatter to a dump slot (drop mode also works, but an
    # explicit dump row keeps the scatter shape static and branch-free).
    xi = jnp.where(inside, xi, 0)
    yi = jnp.where(inside, yi, height)  # row `height` = dump row
    color = objects.base_color[particles.object_index]  # (N, 3)
    img = jnp.ones((height + 1, width, 3), jnp.float32)
    img = img.at[yi, xi].set(jnp.where(inside[:, None], color, 1.0), mode="drop")
    return img[:height]
