"""Multi-process (multi-host) execution test: two REAL worker processes,
real TCP rendezvous, real cross-process (gloo) collectives — the
distributed-bootstrap axis a single-process 8-device mesh cannot exercise
(parallel/multihost.py).

The workers run OUTSIDE pytest (fresh interpreters) because
jax.distributed.initialize must precede all other JAX work in a process.
"""

import os
import socket
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_ROOT, "tests", "mh_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_frame_matches_single_device(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    # CPU-only workers, each with its own 4 virtual CPU devices for the
    # 8-device global mesh
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    outs = [tmp_path / f"w{i}.txt" for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, "--id", str(i), "--procs", "2",
             "--port", str(port), "--out", str(outs[i])],
            env=env, cwd=_ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    logs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=600)
            logs.append(stdout.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out (rendezvous or collective "
                    "hang); partial logs:\n" + "\n".join(logs))

    for i, (p, out) in enumerate(zip(procs, outs)):
        body = out.read_text() if out.exists() else "<no output file>"
        assert p.returncode == 0 and body.startswith("OK"), (
            f"worker {i} rc={p.returncode}: {body}\n--- log ---\n{logs[i][-3000:]}"
        )
