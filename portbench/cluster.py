"""The deployment under test: ``python -m dfs_tpu_torch.cli.main serve``
processes on localhost, one per node, started from a configuration file's
flags, and the HTTP calls the harness makes to them (status, metrics,
manifests, downloads). The start-up follows the cluster phase of the
repository's chip smoke run: fresh ports, one ``cluster.json`` address
book, every node answering ``/status`` before the run goes on."""

from __future__ import annotations

import http.client
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

from portbench.registry import CHECKOUT

FAULTS = Path(__file__).resolve().parent / "faults.py"


def free_ports(n: int) -> list[int]:
    """``n`` distinct ports free now (bound together, then released)."""
    socks, ports = [], []
    try:
        while len(ports) < n:
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


def http_call(port: int, method: str, path: str, body=None,
              headers: dict | None = None,
              timeout: float = 600.0) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _is_digest(name: str) -> bool:
    return len(name) == 64 and all(c in "0123456789abcdef" for c in name)


def _size(path: str) -> int:
    try:
        return os.stat(path).st_size
    except FileNotFoundError:
        return 0


class Cluster:
    """``cfg["nodes"]`` serve processes over one data root, started with
    the configuration's flags; ``fault`` starts every node through
    :mod:`faults` with that fault planted."""

    def __init__(self, cfg: dict, root: Path,
                 fault: str | None = None) -> None:
        self.cfg = cfg
        self.root = Path(root)
        self.ids = list(range(1, cfg["nodes"] + 1))
        ports = free_ports(2 * len(self.ids))
        self.port = {i: ports[2 * (i - 1)] for i in self.ids}
        self.internal = {i: ports[2 * (i - 1) + 1] for i in self.ids}
        self.data = self.root / "data"
        self.fault = fault
        self.procs: dict[int, subprocess.Popen] = {}
        self._logs = []

    def _argv(self, i: int) -> list[str]:
        c = self.cfg
        serve = ["serve", "--node-id", str(i),
                 "--cluster-config", str(self.root / "cluster.json"),
                 "--data-root", str(self.data),
                 "--write-quorum", str(c["write_quorum"]),
                 "--durability", c["durability"],
                 "--min-chunk", str(c["chunk"]["min"]),
                 "--avg-chunk", str(c["chunk"]["avg"]),
                 "--max-chunk", str(c["chunk"]["max"]),
                 *c["serve_flags"]]
        if self.fault:
            return [sys.executable, str(FAULTS), self.fault, *serve]
        return [sys.executable, "-m", "dfs_tpu_torch.cli.main", *serve]

    def start(self, timeout: float = 300.0) -> float:
        """Start every node; returns the seconds until all answer."""
        (self.root / "cluster.json").write_text(json.dumps({
            "replication_factor": self.cfg["replication_factor"],
            "peers": [{"node_id": i, "host": "127.0.0.1",
                       "port": self.port[i],
                       "internal_port": self.internal[i]}
                      for i in self.ids]}))
        env = dict(os.environ, PYTHONPATH=str(CHECKOUT))
        t0 = time.monotonic()
        for i in self.ids:
            log = open(self.root / f"node{i}.log", "ab")
            self._logs.append(log)
            self.procs[i] = subprocess.Popen(
                self._argv(i), cwd=CHECKOUT, env=env, stdout=log,
                stderr=subprocess.STDOUT)
        for i in self.ids:
            while True:
                if self.procs[i].poll() is not None:
                    raise RuntimeError(f"node {i} exited "
                                       f"{self.procs[i].returncode}")
                try:
                    if http_call(self.port[i], "GET", "/status",
                                 timeout=5)[0] == 200:
                        break
                except OSError:
                    pass
                if time.monotonic() - t0 > timeout:
                    raise RuntimeError(f"node {i} did not answer /status")
                time.sleep(0.25)
        return time.monotonic() - t0

    def metrics(self) -> dict[int, dict]:
        out = {}
        for i in self.ids:
            st, body = http_call(self.port[i], "GET", "/metrics",
                                 timeout=120)
            if st != 200:
                raise RuntimeError(f"/metrics on node {i} answered {st}")
            out[i] = json.loads(body)
        return out

    def manifest_table(self, port: int, file_id: str) -> list | None:
        st, body = http_call(port, "GET", f"/manifest?fileId={file_id}",
                             timeout=120)
        if st != 200:
            return None
        return [(c["offset"], c["length"], c["digest"])
                for c in json.loads(body)["chunks"]]

    def download(self, port: int, file_id: str) -> bytes | None:
        st, body = http_call(port, "GET", f"/download?fileId={file_id}")
        return body if st == 200 else None

    def chunk_path(self, node: int, digest: str) -> Path:
        return self.data / f"node-{node}" / "chunks" / digest[:2] / digest

    def pids(self) -> list[int]:
        return [p.pid for p in self.procs.values()]

    def files(self) -> dict[str, tuple[int | None, int]]:
        """Every file under the data root: (size, inode). Chunk files
        (named by their 64-hex digest, never grown in place) have no
        size here: a stat a file is slow on some disks, and the inode
        comes with the directory listing."""
        out: dict[str, tuple[int | None, int]] = {}
        stack = [str(self.data)]
        while stack:
            try:
                it = os.scandir(stack.pop())
            except FileNotFoundError:
                continue
            with it:
                for e in it:
                    if e.is_dir(follow_symlinks=False):
                        stack.append(e.path)
                    else:
                        out[e.path] = (None if _is_digest(e.name)
                                       else _size(e.path), e.inode())
        return out

    def grown_bytes(self, before: dict[str, tuple[int | None, int]]) -> int:
        """Bytes written under the data root since ``before``
        (:meth:`files`): a file that is new or has another inode (written
        anew, renamed over the old) whole, one that kept its inode by its
        change in size (a chunk file that kept its inode: none)."""
        grown = 0
        for path, (size, ino) in self.files().items():
            old = before.get(path)
            if old is not None and old[1] == ino:
                if size is not None:
                    grown += size - (old[0] or 0)
                continue
            grown += _size(path) if size is None else size
        return grown

    def total_bytes(self) -> int:
        """Bytes of every file under the data root (a stat each)."""
        return sum(_size(p) if n is None else n
                   for p, (n, _) in self.files().items())

    def log_tails(self, n: int = 2000) -> str:
        out = []
        for i in self.ids:
            p = self.root / f"node{i}.log"
            if p.is_file():
                out.append(f"--- node {i} ---\n"
                           + p.read_bytes()[-n:].decode("utf-8", "replace"))
        return "\n".join(out)

    def stop(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
        for p in self.procs.values():
            p.wait(timeout=60)
        for f in self._logs:
            f.close()
        self._logs.clear()
