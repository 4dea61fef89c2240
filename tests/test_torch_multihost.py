"""One sharded program across two processes (``parallel/multihost.py``):
two real OS processes join a ``torch.distributed`` group over gloo, each
with two CPU slots, and run the rolling step, the carry bitmap step and
the anchored pass B over the global mesh at dp 1 (sp spans both processes,
so the halo crosses over gloo) and dp 2
(``multihost.multihost_parity_check``). Each process checks its own
slots' outputs against the NumPy oracles and the all-reduced counts
against the whole input's, as dfs_tpu's ``tests/test_multihost.py``
does. The workers import neither JAX nor dfs_tpu."""

import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

WORKER = r"""
import json, sys
coord, pid = sys.argv[1], int(sys.argv[2])
from dfs_tpu_torch.parallel.multihost import (init_multihost,
                                              multihost_parity_check)
init_multihost(coord, 2, pid)
print(json.dumps(multihost_parity_check(["cpu", "cpu"])))
print(f"WORKER{pid}-OK", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_global_mesh(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(script), coord, str(pid)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
             "HOME": str(tmp_path), "OMP_NUM_THREADS": "1"})
        for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"WORKER{pid}-OK" in out, f"worker {pid} output:\n{out}"
