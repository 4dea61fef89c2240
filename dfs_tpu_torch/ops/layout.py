"""Kernel 3: byte-swap + transpose into the lane-minor layout.

Replaces ``dfs_tpu/ops/layout.py:bswap_transpose`` (Pallas body
``_kernel``): ``[S, W]`` u32 little-endian lanes -> ``[W, S]`` u32
big-endian words, ``out = bswap32(x).T`` — the layout the strip scan
(kernel 1) reads with coalesced per-lane loads.

CUDA design (``csrc/bswap_transpose.cu``): the classic shared-memory tiled
transpose — 32x32 tiles with one word of padding per row against bank
conflicts, 32x8 threads, coalesced reads along rows and coalesced writes
along the transposed rows, ``__byte_perm`` for the swap. What bounds it on
this card: bytes (one read and one write of the lanes). Kernels 2 and 3
stay separate here so each is held against its own plain version; fusing
them so the packed intermediate never reaches device memory is later work.

Plain version: :func:`bswap_transpose_plain`.
"""

from __future__ import annotations

import torch

from dfs_tpu_torch import kernels
from dfs_tpu_torch.utils import u32

NAME = "bswap_transpose"


def bswap32(x: torch.Tensor) -> torch.Tensor:
    """Elementwise u32 byte swap of a uint32 tensor."""
    return u32.narrow(u32.bswap32(u32.widen(x)))


def bswap_transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """[S, W] u32 LE -> [W, S] u32 BE."""
    return bswap32(x).view(torch.int32).T.contiguous().view(torch.uint32)


def bswap_transpose(x: torch.Tensor) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise)."""
    if x.device.type == "cpu":
        return bswap_transpose_plain(x)
    kernels.check_cuda(NAME, x, torch.uint32, 2)
    rows, cols = x.shape
    out = torch.empty((cols, rows), dtype=torch.uint32, device=x.device)
    kernels.launch(NAME, x.device, x.data_ptr(), out.data_ptr(), rows, cols)
    return out
