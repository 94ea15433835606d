"""spacetime_tpu — a JAX (XLA + Pallas) 2+1D special-relativistic softbody
engine with retarded-time raytracing.

A ground-up rebuild of the capabilities of `ccs-cs1l-f24/spacetime-raytracer`
(Rust + Vulkan compute): SoA pytree state, one jitted step/render loop, a
collision cell table, a device-resident worldline ring buffer, and a fused
past-light-cone pixel pass (a Pallas kernel on GPUs, paths.py).
"""

from . import constants, relativity, scene, state
from .constants import DEFAULT_PARAMS, PhysicsParams
from .state import Objects, Particles

__version__ = "0.1.0"
