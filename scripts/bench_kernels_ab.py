#!/usr/bin/env python3
"""Kernels 1-5 of one tree at the default 64 MiB region, for comparing two
trees on one card: ``chip_smoke.py``'s region (seed 20261016) made with
the tree's own package, each kernel timed per launch back to back at 20
and 100 launches and with one event pair a call (``chip_smoke``'s
``kernel_times``). Prints one JSON line, labelled.

Run two trees in turns in one call, so that both meet the same card:
unpack the other tree (``git archive <commit>``) into a directory that
``.gitignore`` lists, then

    for t in A B B A; do python scripts/bench_kernels_ab.py <root of t> $t; done

Each run builds that tree's kernels first (``dfs_tpu_torch/_build/``).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def main(root: Path, label: str) -> None:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as C
    from dfs_tpu_torch import kernels
    from dfs_tpu_torch.ops import cdc_anchored as A
    from dfs_tpu_torch.ops.layout import bswap_transpose
    from dfs_tpu_torch.ops.repack import repack_lanes
    from dfs_tpu_torch.ops.select import select_walk
    from dfs_tpu_torch.ops.sha256_strip import (strip_chunk_states,
                                                strip_states)

    if not kernels.__file__.startswith(str(root)):
        raise SystemExit(f"bench_kernels_ab: imported {kernels.__file__}, "
                         f"not the tree at {root}")
    kernels.build_all()
    dev = torch.device("cuda", 0)
    r = C.region_inputs(np.random.default_rng(C.SEED), dev, np)
    p, cp = r.params, r.params.chunk
    cap, s_pad = r.shape["cap"], r.shape["s_pad"]

    def walk():
        return select_walk(r.tiles, r.scal, cap, p.seg_min, p.seg_max)

    (_, _, w_off, sh8, rb, _, _, _) = A.descriptors(walk(), r.scal[0], s_pad)
    lw = cp.strip_blocks * 16
    packed = repack_lanes(r.words, w_off, sh8, lw)
    words_t = bswap_transpose(packed)
    args = (words_t, rb, cp.seed, cp.mask, cp.min_blocks, cp.max_blocks)
    cutflag = strip_chunk_states(*args)[0]
    out = {"tree": label, "card": torch.cuda.get_device_name(0)}
    for name, fn in (
            ("strip_chunk_states", lambda: strip_chunk_states(*args)),
            ("strip_states", lambda: strip_states(words_t, cutflag)),
            ("repack_lanes", lambda: repack_lanes(r.words, w_off, sh8, lw)),
            ("bswap_transpose", lambda: bswap_transpose(packed)),
            ("select_walk", walk)):
        t = C.kernel_times(fn, single_reps=10)
        out[name] = {k: t[k] for k in ("ms", "ms_n20", "ms_single")}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit("usage: bench_kernels_ab.py <tree root> <label>")
    main(Path(sys.argv[1]).resolve(), sys.argv[2])
