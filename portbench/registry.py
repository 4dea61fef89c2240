"""The benchmark's registry: ``BENCHMARK.json`` names the cells and the
metrics, and everything that belongs to one configuration, one traffic
mix or one per-layer metric sits in a file of its own that is found by
its name:

- ``configs/<config>.json``: one deployment (its source, the ``serve``
  flags it sets, its guarantees, its cuts of scale);
- ``traffic/<mix>.json``: the parameters the one general generator
  (:mod:`generator`) reads;
- ``metrics/<metric>.py``: a reader with ``read(ctx)`` that returns the
  metric's value, or None where the run gave it nothing to read.

A later change adds a cell, a deployment, a mix or a metric by adding
files and entries; no file here names one of them.
"""

from __future__ import annotations

import importlib.util
import json
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


class RegistryError(ValueError):
    """A name that no file answers to, or a file that is malformed."""


def load_benchmark(path: Path | None = None) -> dict:
    path = Path(path) if path is not None else CHECKOUT / "BENCHMARK.json"
    if not path.is_file():
        raise RegistryError(f"no benchmark file at {path}")
    return json.loads(path.read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise RegistryError(f"no workload {name!r} in the benchmark")


def _named_file(root: Path, kind: str, name: str, suffix: str) -> Path:
    path = root / kind / f"{name}{suffix}"
    if not path.is_file():
        raise RegistryError(f"no {kind[:-1]} file {path}")
    return path


def load_config(name: str, root: Path = HERE) -> dict:
    """A deployment: the serve flags, the guarantees, the chunk sizes."""
    cfg = json.loads(_named_file(root, "configs", name, ".json").read_text())
    for key in ("source", "nodes", "replication_factor", "write_quorum",
                "durability", "serve_flags", "chunk"):
        if key not in cfg:
            raise RegistryError(f"config {name!r} lacks {key!r}")
    return cfg


def load_mix(name: str, root: Path = HERE) -> dict:
    """A traffic mix: the generator's parameters."""
    mix = json.loads(_named_file(root, "traffic", name, ".json").read_text())
    for key in ("file_bytes", "block_bytes", "agents", "base",
                "edits", "warm_uploads"):
        if key not in mix:
            raise RegistryError(f"traffic mix {name!r} lacks {key!r}")
    return mix


def load_reader(name: str, root: Path = HERE) -> types.ModuleType:
    """The module of a per-layer metric's reader (its file name is the
    metric's name, dots and all, so it is loaded by path)."""
    path = _named_file(root, "metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise RegistryError(f"metric reader {path} has no read(ctx)")
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
    that list it under ``workloads``, and those that list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]
