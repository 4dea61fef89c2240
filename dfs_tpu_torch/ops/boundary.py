"""Greedy chunk-boundary selection from a candidate bitmap — a copy of
dfs_tpu's ``ops/boundary.py``, the ``cdc`` strategy's selection rule:

- scanning from chunk start ``s``, cut after the first candidate position
  ``i`` with ``i - s + 1 >= min_size``;
- with no candidate before the chunk reaches ``max_size``, cut at
  ``s + max_size - 1``;
- the final chunk may be shorter than ``min_size``.
"""

from __future__ import annotations

import numpy as np


def select_cuts(candidates: np.ndarray, n: int,
                min_size: int, max_size: int) -> np.ndarray:
    """candidates: bool bitmap [n] or sorted int positions. Returns the
    exclusive cut offsets, the last one == n (n == 0: empty)."""
    if n == 0:
        return np.zeros((0,), dtype=np.int64)
    if candidates.dtype == np.bool_:
        pos = np.flatnonzero(candidates).astype(np.int64)
    else:
        pos = np.asarray(candidates, dtype=np.int64)

    cuts: list[int] = []
    start = 0
    while start < n:
        lo = start + min_size - 1      # earliest admissible cut position
        hi = start + max_size - 1      # forced cut position
        j = int(np.searchsorted(pos, lo, side="left"))
        if j < pos.shape[0] and pos[j] <= hi:
            cut = int(pos[j])
        else:
            cut = min(hi, n - 1)
        cuts.append(cut + 1)
        start = cut + 1
    return np.asarray(cuts, dtype=np.int64)


def cuts_to_spans(cuts: np.ndarray) -> list[tuple[int, int]]:
    """Exclusive cut offsets -> [(offset, length)] spans."""
    spans = []
    prev = 0
    for c in cuts.tolist():
        spans.append((prev, int(c) - prev))
        prev = int(c)
    return spans
