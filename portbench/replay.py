"""After the window, the cell's own upload bodies through the node's
fragmenter (the same ``get_fragmenter`` call with the same kind and sizes)
in the harness's process: timed on the host clock between device
synchronisations, then once more under ``torch.profiler``. ``serve`` takes
no profile of its own yet, so this stands in for one."""

from __future__ import annotations

import json
import time
from pathlib import Path

REGION_BYTES = 64 * 1024 * 1024
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "python_function", "cuda_runtime", "cuda_driver",
              "user_annotation")


def make_fragmenter(cfg: dict, device=None):
    from dfs_tpu_torch.config import CDCParams
    from dfs_tpu_torch.fragmenter.base import get_fragmenter

    c = cfg["chunk"]
    return get_fragmenter(cfg["fragmenter"], cdc_params=CDCParams(
        min_size=c["min"], avg_size=c["avg"], max_size=c["max"]),
        device=device)


def _walk(frag, data, block: int) -> list:
    mv = memoryview(data)
    out = []
    for batch in frag.chunks_stream(
            (mv[i:i + block] for i in range(0, len(mv), block)),
            store=lambda digest, payload: None):
        out.extend(batch)
    return out


def merge(intervals: list[tuple[float, float]]) -> list[list[float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(path: Path) -> dict:
    """Device busy seconds (the union of every device op's interval), the
    device ops by total seconds, and the longest idle gaps between them,
    each named by the innermost host event that spans its middle."""
    doc = json.loads(Path(path).read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e.get("cat") in _DEVICE_CATS:
            dev.append((span, e.get("name", "?")))
        elif e.get("cat") in _HOST_CATS:
            host.append((span, e.get("name", "?")))
    by_name: dict[str, float] = {}
    for (s, t), name in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s) * 1e-6
    busy = merge([span for span, _ in dev])
    longest = sorted(((b - a, a, b) for (_, a), (b, _)
                      in zip(busy, busy[1:])), reverse=True)[:10]
    gaps = []
    for width, a, b in longest:
        mid = (a + b) / 2
        inner = [(t - s, name) for (s, t), name in host if s <= mid <= t]
        gaps.append([min(inner)[1] if inner else "host outside torch ops",
                     width * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": sum(t - s for s, t in busy) * 1e-6,
            "device_ops": [[k, v] for k, v in ops[:10]],
            "idle_gaps": gaps, "device_op_count": len(dev)}


def run(cfg: dict, bodies: list, block: int, trace_path: Path,
        profiled: int = 2) -> dict:
    """Times the fragmenter over ``bodies`` and profiles it over the first
    ``profiled``; returns the readings."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    frag = make_fragmenter(cfg)
    _walk(frag, bodies[0], block)                     # warm
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for b in bodies:
        _walk(frag, b, block)
    torch.cuda.synchronize()
    timed_s = time.monotonic() - t0
    n = sum(len(b) for b in bodies)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        p0 = time.monotonic()
        for b in bodies[:profiled]:
            _walk(frag, b, block)
        torch.cuda.synchronize()
        window_s = time.monotonic() - p0
    prof.export_chrome_trace(str(trace_path))
    out = read_trace(trace_path)
    out.update({"engine": frag.name, "timed_s": timed_s, "bytes": n,
                "ms_per_region": timed_s * 1e3 / (n / REGION_BYTES),
                "window_s": window_s,
                "profiled_bytes": sum(len(b) for b in bodies[:profiled]),
                "memory_peak_bytes": torch.cuda.max_memory_reserved()})
    return out
