"""Multi-chip scaling: device meshes and sharded step/render.

The reference is strictly single-GPU/single-queue (SURVEY.md §2: no
DP/TP/PP/SP/EP, one Vulkan queue, boilerplate.rs:646-656).  This engine adds
the scaling story the reference never had, mapped to this domain:

  * data parallel   -> pixels/rays sharded across chips (render)
  * "tensor"/model  -> particle axis sharded across chips (physics AND the
                       worldline ring planes: one consistent axis means
                       pushes and the per-particle cone sweep never reshard)

The worldline history (T) axis — the reference's analog of sequence length
(SURVEY.md §5) — is deliberately NOT sharded: each per-tick push writes one
column across the whole history, so a T-sharded layout would reshard every
frame.  Long history scales by device memory, not by compute.

Sharding is expressed with jax.sharding.NamedSharding under jit (GSPMD): XLA
inserts the all-gathers/permutes/reductions between devices.  Everything
works on a
CPU mesh of virtual devices for testing (tests/test_parallel.py) and is
validated by __graft_entry__.dryrun_multichip.

Beyond one host: `multihost` (imported lazily — it must be usable before
backend init) joins one JAX process per host into the same GSPMD programs
via jax.distributed.  tests/test_multihost.py runs it for real: two worker
processes, TCP rendezvous, gloo cross-process collectives.
tools/launch_multihost.py is the torchrun-equivalent launcher.
"""

from . import mesh, sharding
