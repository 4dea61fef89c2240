"""Kernel 4: the segment-selection walk.

Replaces ``dfs_tpu/ops/select_pallas.py:make_select_fn_pallas`` (Pallas
body ``kernel``; XLA twin ``ops/cdc_anchored.py:make_select_fn``). From the
anchor tile table (first two kept anchors per ``TILE_BYTES`` tile, 2**30 =
none) it walks segment boundaries in stream order:

    lo = start + seg_min,  hi = start + seg_max
    bound = last kept anchor p with lo-1 <= p <= hi-1, plus 1; else hi
    bound = n once n - start <= seg_max (final segment)
    a non-final region withholds its tail segment; -1 pads the rest

CUDA design (``csrc/select_walk.cu``): one block of one warp runs the
whole ``cap``-step loop. Each step the 32 threads read the ``2 * win``
window entries (``win = (seg_max - seg_min) / TILE_BYTES + 1`` tiles from
each plane), keep the in-range ones, and warp max-reduce with
``__shfl_xor_sync``; thread 0 writes the bound. ``start0``, ``n`` and
``final`` are read from device memory, so a walk chained on a device
carry never syncs with the host. What bounds it on this card: latency —
each step depends on the previous bound, so the walk is a chain of
~``cap`` dependent L2 round trips; bytes and operations are negligible.

Plain version: :func:`select_walk_plain` (the ``make_select_fn`` scan as a
Python loop over tensor steps).
"""

from __future__ import annotations

import torch

from dfs_tpu_torch import kernels

NAME = "select_walk"

TILE_BYTES = 512
NO_ANCHOR = 2**30


def select_window_tiles(seg_min: int, seg_max: int) -> int:
    """Selection-window width in tiles (per anchor plane)."""
    return (seg_max - seg_min) // TILE_BYTES + 1


def select_walk_plain(tiles: torch.Tensor, scal: torch.Tensor, cap: int,
                      seg_min: int, seg_max: int) -> torch.Tensor:
    """(tiles [2, m_tiles] i32, scal [3] i32 = (start0, n, final)) ->
    bounds [cap] i32."""
    dev = tiles.device
    win = select_window_tiles(seg_min, seg_max)
    m_tiles = tiles.shape[1]
    tiles_p = torch.cat([tiles.to(torch.int64),
                         torch.full((2, win), NO_ANCHOR, dtype=torch.int64,
                                    device=dev)], dim=1)
    sc = scal.to(torch.int64)
    start, n, final = sc[0], sc[1], sc[2] != 0
    done = torch.zeros((), dtype=torch.bool, device=dev)
    idx = torch.arange(win, device=dev)
    outs = []
    for i in range(cap):
        lo = start + seg_min
        hi = start + seg_max
        # the twin's dynamic_slice clamps its start into the padded table
        t0 = torch.clamp((lo - 1) // TILE_BYTES, 0, m_tiles)
        w = tiles_p[:, t0 + idx]
        valid = (w >= lo - 1) & (w <= hi - 1)
        last = torch.where(valid, w, -1).max()
        b = torch.where(last >= 0, last + 1, hi)
        fin = n - start <= seg_max
        b = torch.where(fin, n, b)
        out = torch.where(done | (fin & ~final), -1, b)
        start = torch.where(out >= 0, b, start)
        done = done | fin
        outs.append(out)
        if i % 8 == 7 and bool(done):     # the rest is -1 padding
            break
    bounds = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    bounds[:len(outs)] = torch.stack(outs).to(torch.int32)
    return bounds


def select_walk(tiles: torch.Tensor, scal: torch.Tensor, cap: int,
                seg_min: int, seg_max: int) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise). ``scal`` = (start0, n, final) as a device int32 [3]."""
    if tiles.device.type == "cpu":
        return select_walk_plain(tiles, scal, cap, seg_min, seg_max)
    kernels.check_cuda(NAME, tiles, torch.int32, 2)
    kernels.check_cuda(NAME, scal, torch.int32, 1)
    if tiles.shape[0] != 2 or scal.shape[0] != 3:
        raise ValueError(f"{NAME}: bad shapes")
    bounds = torch.empty((cap,), dtype=torch.int32, device=tiles.device)
    kernels.launch(NAME, tiles.device, tiles.data_ptr(), tiles.shape[1],
                   scal.data_ptr(), bounds.data_ptr(), cap,
                   select_window_tiles(seg_min, seg_max), seg_min, seg_max,
                   TILE_BYTES)
    return bounds
