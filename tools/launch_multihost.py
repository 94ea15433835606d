"""Multi-process launcher: the torchrun equivalent for this engine.

Spawns N ranks of a command with the env contract parallel/multihost.py
reads (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID), so a
script that calls `multihost.initialize()` first joins them into one global
JAX runtime:

    # 2 local CPU ranks x 4 virtual devices = one 8-device DCN-style mesh
    python tools/launch_multihost.py -n 2 --cpu-devices 4 -- \
        python my_sim.py --config flagship_1080p

    # rank of a REAL multi-host deployment (run once per host; rank 0's
    # host serves the coordinator)
    python tools/launch_multihost.py --rank 1 --nprocs 4 \
        --coordinator host0:29500 -- python my_sim.py

    # one rank per card of a 4-GPU host: rank r opens only card r
    python tools/launch_multihost.py -n 4 -- python my_sim.py

Local mode (-n) streams each rank's output with a `[rk]` prefix and exits
non-zero if any rank does.  --cpu-devices forces CPU ranks with that many
virtual devices each.  Without it, local rank r is given card r alone
(SPACETIME_LOCAL_DEVICES, read by parallel/multihost.initialize): a JAX
process reserves most of each card it opens, so ranks must not share one.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(base, coordinator: str, nprocs: int, rank: int,
              cpu_devices: int | None, local_card: int | None = None):
    env = dict(base)
    env["JAX_COORDINATOR_ADDRESS"] = coordinator
    env["JAX_NUM_PROCESSES"] = str(nprocs)
    env["JAX_PROCESS_ID"] = str(rank)
    if local_card is not None and not cpu_devices:
        env["SPACETIME_LOCAL_DEVICES"] = str(local_card)
    if cpu_devices:
        env["JAX_PLATFORMS"] = "cpu"
        flags = [
            f for f in env.get("XLA_FLAGS", "").split()
            if "xla_force_host_platform_device_count" not in f
        ]
        flags.append(f"--xla_force_host_platform_device_count={cpu_devices}")
        env["XLA_FLAGS"] = " ".join(flags)
    return env


def _stream(prefix: str, pipe):
    for line in iter(pipe.readline, b""):
        sys.stdout.write(f"[{prefix}] {line.decode(errors='replace')}")
        sys.stdout.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        usage="launch_multihost.py [options] -- CMD [ARGS...]")
    ap.add_argument("-n", "--local-ranks", type=int, default=0,
                    help="spawn this many LOCAL ranks (all on this host)")
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="force CPU ranks with this many virtual devices each")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's coordination service "
                         "(default: a free local port)")
    ap.add_argument("--rank", type=int, default=None,
                    help="single-rank mode: run CMD as this rank and exit")
    ap.add_argument("--nprocs", type=int, default=None,
                    help="total ranks (single-rank mode)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="command to run (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no command given (append: -- python my_script.py ...)")

    if args.rank is not None:
        # single-rank passthrough: exec CMD with the env contract set
        if not (args.nprocs and args.coordinator):
            ap.error("--rank needs --nprocs and --coordinator")
        env = _rank_env(os.environ, args.coordinator, args.nprocs, args.rank,
                       args.cpu_devices or None)
        return subprocess.call(cmd, env=env)

    n = args.local_ranks or 2
    coordinator = args.coordinator or f"127.0.0.1:{_free_port()}"
    procs, threads = [], []
    for r in range(n):
        p = subprocess.Popen(
            cmd,
            env=_rank_env(os.environ, coordinator, n, r,
                          args.cpu_devices or None, local_card=r),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        t = threading.Thread(target=_stream, args=(str(r), p.stdout),
                             daemon=True)
        t.start()
        procs.append(p)
        threads.append(t)
    rc = 0
    for p in procs:
        rc = rc or p.wait()
    for t in threads:
        t.join(timeout=5)
    return rc


if __name__ == "__main__":
    sys.exit(main())
