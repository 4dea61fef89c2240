"""Kernel 4: the segment-selection walk.

Replaces ``dfs_tpu/ops/select_pallas.py:make_select_fn_pallas`` (Pallas
body ``kernel``; XLA twin ``ops/cdc_anchored.py:make_select_fn``). From the
anchor tile table (first two kept anchors per ``TILE_BYTES`` tile, 2**30 =
none) it walks segment boundaries in stream order:

    lo = start + seg_min,  hi = start + seg_max
    bound = last kept anchor p with lo-1 <= p <= hi-1, plus 1; else hi
    bound = n once n - start <= seg_max (final segment)
    a non-final region withholds its tail segment; -1 pads the rest

CUDA design (``csrc/select_walk.cu``): the window scan is taken off the
dependent chain. ``seg_min`` and ``seg_max`` are multiples of
``TILE_BYTES``, so the window's tiles hold exactly the bytes around
``[lo-1, hi-1]``, and its max equals ``pred(hi-1)`` (the largest kept anchor
``<= hi-1``) whenever that is ``>= lo-1``: anchors are sorted across tiles
and within each tile. Two kernels in one launch: the first, over the whole
card, turns the table into records ``{e0, e1, q}`` (``q`` the max anchor of
the ``(seg_max - seg_min) / TILE_BYTES`` tiles before, or more) in a
scratch of :func:`record_words` int32; the second, one warp, streams the
records into a shared-memory ring of 4 chunks of 4096 tiles with bulk
asynchronous copies (TMA, one mbarrier a slot, two chunks ahead) and takes
each step from one record, ``pred(x) = max(e0 <= x ? e0 : q, e1 <= x ?
e1 : q)``: one shared-memory load and nine dependent integer instructions,
checking that the chunks it reads have arrived once per burst of
``min(8, 2 MiB / seg_max)`` steps (at least one; 8 at the default
``seg_max`` of 128 KiB), so any ``seg_max`` walks. ``start0``, ``n`` and
``final`` are read from device memory, so a walk chained on a device carry
never syncs with the host. What bounds it on this card: latency — each
step depends on the previous bound (~550 steps per 64 MiB region); bytes
and operations are small beside the chain.

Plain version: :func:`select_walk_plain` (the ``make_select_fn`` scan as a
Python loop over tensor steps).
"""

from __future__ import annotations

import torch

from dfs_tpu_torch import kernels

NAME = "select_walk"

TILE_BYTES = 512
TILE_SHIFT = TILE_BYTES.bit_length() - 1
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
    if seg_min % TILE_BYTES or seg_max % TILE_BYTES:
        raise ValueError(f"{NAME}: seg_min and seg_max must be multiples "
                         f"of {TILE_BYTES}")
    m_tiles = tiles.shape[1]
    bounds = torch.empty((cap,), dtype=torch.int32, device=tiles.device)
    records = torch.empty((record_words(m_tiles),), dtype=torch.int32,
                          device=tiles.device)
    kernels.launch(NAME, tiles.device, tiles.data_ptr(), m_tiles,
                   scal.data_ptr(), bounds.data_ptr(), cap, seg_min, seg_max,
                   TILE_SHIFT, records.data_ptr())
    return bounds


def record_words(m_tiles: int) -> int:
    """The int32 count of the kernel's records scratch for ``m_tiles``
    tiles, as the kernel's source sizes it (its record ring's chunks)."""
    return int(kernels.library(NAME).dfs_select_walk_records(m_tiles))
