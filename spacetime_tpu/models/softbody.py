"""Softbody model: the jitted stepping API over the ops layer.

The functional analog of `SoftbodyState` (reference:
src/twoplusone/softbody/mod.rs:191-221) — but where the reference owns
buffers, descriptor sets and command recording, this owns only *static
configuration* (capacity-derived table sizes, parameters); the state itself
is a `Particles` pytree threaded through pure jitted functions.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..constants import DEFAULT_PARAMS, PhysicsParams
from ..ops import rk4 as rk4_ops
from ..state import Particles


@dataclasses.dataclass(frozen=True)
class SoftbodyModel:
    """Static config + compiled step for a fixed particle capacity."""

    capacity: int
    params: PhysicsParams = DEFAULT_PARAMS
    # Dense cell-grid live extent = grid_dim * grid_resolution lightseconds
    # (512 -> 2.56 ls); the origin floats with the scene each step.
    grid_dim: int = 512
    # Two interpenetrating lattices pack 8 particles per 0.005-cell at rest
    # (4 each at 0.0035 spacing); 16 leaves room for the compression of an
    # impact (at 8 the flagship scene drops candidates from frame ~115 on).
    # Candidates past it are lost forces (StepAux.grid_overflow); the
    # engine doubles it on that evidence.
    cell_capacity: int = 16
    integrator: str = "rk4"
    # per-slot neighbor index offsets (forces.derive_spring_offsets) — when
    # set, bond breaking reads bonded positions by static shifted slices
    # instead of row gathers (needs a lattice-padded scene layout)
    spring_offsets: Optional[tuple] = None

    def rest_lengths(self) -> jax.Array:
        return jnp.asarray(self.params.rest_lengths())

    @partial(jax.jit, static_argnames=("self",))
    def step(self, particles: Particles, materials=None) -> tuple[Particles, rk4_ops.StepAux]:
        """One physics frame (grid rebuild + RK4) — `submit_per_frame_compute`
        (reference: softbody/mod.rs:557-596).  `materials` is an optional
        ops.materials.ParticleMaterials pytree (per-particle stiffness /
        damping / break-threshold planes)."""
        return self._physics_step(particles, materials)

    def _physics_step(self, particles, materials):
        return rk4_ops.physics_step(
            particles, self.params, self.rest_lengths(), self.grid_dim,
            self.cell_capacity, self.integrator, self.spring_offsets,
            materials=materials,
        )

    @partial(jax.jit, static_argnames=("self", "n_steps"))
    def step_n(self, particles: Particles, n_steps: int, materials=None
               ) -> tuple[Particles, rk4_ops.StepAux]:
        """`n_steps` frames fused into one XLA program via lax.scan — the
        equivalent of queueing multiple physics submissions without host
        round-trips."""

        def body(p, _):
            return self._physics_step(p, materials)

        particles, auxs = jax.lax.scan(body, particles, None, length=n_steps)
        last = jax.tree.map(lambda a: a[-1], auxs)
        return particles, last
