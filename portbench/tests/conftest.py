"""Shared pieces of the benchmark's tests: a registry of tiny cells that
runs on the CPU (the nodes' chain on ``--device cpu``, files small enough
for a test), and a skip for tests that need the card, decided in a
fixture."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
CHECKOUT = BENCH.parent


def write_tiny_registry(root: Path, file_bytes: int = 1536 * 1024) -> Path:
    """A registry beside the real one: config ``tiny`` (fastcdc-8k's, on
    the CPU), mix ``tiny-incr`` (backup-incr's, small files), every real
    metric reader, and a benchmark file naming the one cell
    ``tiny.tiny-incr``. Returns the benchmark file."""
    for d in ("configs", "traffic", "metrics"):
        (root / d).mkdir(parents=True, exist_ok=True)
    cfg = json.loads((BENCH / "configs" / "fastcdc-8k.json").read_text())
    cfg["name"] = "tiny"
    cfg["serve_flags"] = [("cpu" if f == "cuda" else f)
                          for f in cfg["serve_flags"]]
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "traffic" / "backup-incr.json").read_text())
    mix["file_bytes"] = file_bytes
    (root / "traffic" / "tiny-incr.json").write_text(json.dumps(mix))
    for p in (BENCH / "metrics").glob("*.py"):
        shutil.copy(p, root / "metrics" / p.name)
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": "tiny.tiny-incr", "config": "tiny",
                           "traffic": "tiny-incr", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    path = root / "benchmark.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture
def cuda_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch
