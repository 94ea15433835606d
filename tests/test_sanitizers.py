"""Runtime sanitizers — this engine's analog of the reference's Vulkan
validation layer + debug messenger (SURVEY.md §5: boilerplate.rs:435-533).

`checkify` instruments the jitted physics step with NaN/div/OOB checks the
way the validation layer instruments command submission; the invariant tests
assert the physical guarantees the reference only eyeballed.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import checkify

from spacetime_tpu import scene
from spacetime_tpu.constants import DEFAULT_PARAMS
from spacetime_tpu.ops import rk4 as rk4_ops


def _collision_scene():
    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(5, 0, (0.0, 0.0), (0.3, 0.0)))
    sb.add(scene.disc_softbody(5, 1, (0.06, 0.002), (-0.3, 0.0)))
    return sb.build(capacity=256)


def test_checkify_clean_through_collision():
    """No NaN/Inf/divide-by-zero/OOB anywhere in the XLA physics step, even
    through a hard collision (the div-guard paths in forces.py are load-
    bearing, not decorative)."""
    p, _ = _collision_scene()
    rest = jnp.asarray(DEFAULT_PARAMS.rest_lengths())

    def step(q):
        q, aux = rk4_ops.physics_step(
            q, DEFAULT_PARAMS, rest, 64, 16, "rk4"
        )
        return q

    checked = checkify.checkify(
        jax.jit(step), errors=checkify.float_checks | checkify.index_checks
    )
    q = p
    for _ in range(60):
        err, q = checked(q)
        err.throw()  # raises with a located message on any NaN/OOB
    act = np.asarray(q.active)
    assert np.isfinite(np.asarray(q.pos)[act]).all()


def test_speed_invariant_never_reaches_c():
    """|v| < c for every active particle at every step (the reference clamps
    at 0.9999c, softbodyrk4.glsl:227); checked through the impact."""
    p, _ = _collision_scene()
    rest = jnp.asarray(DEFAULT_PARAMS.rest_lengths())
    step = jax.jit(lambda q: rk4_ops.physics_step(
        q, DEFAULT_PARAMS, rest, 64, 16, "rk4")[0])
    q = p
    vmax = 0.0
    for _ in range(120):
        q = step(q)
        act = np.asarray(q.active)
        speeds = np.linalg.norm(np.asarray(q.vel)[act], axis=-1)
        vmax = max(vmax, float(speeds.max()))
        assert speeds.max() < 1.0
    assert vmax > 0.29  # the scene actually moved relativistically


def test_checkify_catches_injected_nan():
    """The harness itself is live: a poisoned input is reported, not
    silently propagated."""
    p, _ = _collision_scene()
    rest = jnp.asarray(DEFAULT_PARAMS.rest_lengths())
    bad_pos = p.pos.at[0, 0].set(jnp.nan)
    import dataclasses

    bad = dataclasses.replace(p, pos=bad_pos)

    def step(q):
        return rk4_ops.physics_step(
            q, DEFAULT_PARAMS, rest, 64, 16, "rk4"
        )[0]

    checked = checkify.checkify(jax.jit(step), errors=checkify.float_checks)
    err, _ = checked(bad)
    try:
        err.throw()
        raised = False
    except Exception:
        raised = True
    assert raised
