"""Spawning a ``torch.distributed`` world of the port on the CPU for the
tests.

``run_world(code, n, ...)`` starts ``n`` Python processes running
``code`` with the port's three world variables (a free local port found
by binding port 0), gloo being what ``initialize_from_env(device="cpu")``
brings up. Each process gets one compute thread, imports only the port
(the code asserts that no JAX module was loaded) and exchanges data
with the test through files under a directory the test passes in. A
process that does not finish within ``timeout`` seconds is killed and
fails the test, so a hang cannot eat the suite's time limit.
"""

import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: appended to every worker: the port must not have pulled in JAX
NO_JAX = """
import sys as _sys
_bad = sorted(m for m in _sys.modules
              if m.split('.')[0] in ('jax', 'jaxlib', 'predictionio_tpu'))
assert not _bad, _bad
print("WORKER OK", flush=True)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(code: str, n: int, args=(), env=None, timeout: float = 120.0):
    """Run ``code`` as ranks ``0..n-1`` of one world; returns their
    outputs (stdout and stderr together) in rank order, after asserting
    that every rank exited 0 and reached the end of ``code``."""
    port = free_port()
    procs = []
    try:
        for rank in range(n):
            e = dict(os.environ)
            e.pop("PYTEST_CURRENT_TEST", None)
            e.update(env or {})
            e.update({
                "PYTHONPATH": ROOT,
                "OMP_NUM_THREADS": "1",
                "PIO_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                "PIO_NUM_PROCESSES": str(n),
                "PIO_PROCESS_ID": str(rank),
            })
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code + NO_JAX, *map(str, args)],
                cwd=ROOT, env=e, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert "WORKER OK" in out, f"rank {rank}:\n{out}"
    return outs
