"""Kernel 2: segment repack — one lane per segment, byte-phase funnel shift.

Replaces ``dfs_tpu/ops/repack.py:repack_lanes`` (Pallas body
``_make_kernel.kernel``). Lane ``s`` is the ``lane_words`` words starting
at word ``w_off[s]`` of the region buffer, each funnel-shifted right by
``sh8[s]`` bits against the next word, so the lane starts exactly at the
segment's first byte. Callers guarantee ``w_off + lane_words + 1 <= M``
(the region buffer's lane slack); like the twin, an out-of-range start is
clamped to the last in-bounds window rather than read past the end.

CUDA design (``csrc/repack_lanes.cu``): a grid over (word-chunk, lane),
one output word per thread from two neighbouring input words through
``__funnelshift_r``. What bounds it on this card: bytes — one read of the
lanes' source words and one write of the packed lanes, no arithmetic to
speak of; consecutive threads touch consecutive words, so loads and stores
coalesce and the neighbour read hits L1.

Plain version: :func:`repack_lanes_plain` (the ``repack_lanes_xla`` twin:
an index gather plus the funnel shift in int64).
"""

from __future__ import annotations

import torch

from dfs_tpu_torch import kernels
from dfs_tpu_torch.utils import u32

NAME = "repack_lanes"


def repack_lanes_plain(words: torch.Tensor, w_off: torch.Tensor,
                       sh8: torch.Tensor, lane_words: int) -> torch.Tensor:
    """(words [M] u32 LE, w_off [s_pad] i32, sh8 [s_pad] u32) -> packed
    [s_pad, lane_words] u32 LE."""
    m_total = words.shape[0]
    start = w_off.to(torch.int64).clamp(0, m_total - lane_words - 1)
    idx = start[:, None] + torch.arange(lane_words + 1, device=words.device)
    x = u32.widen(words.view(torch.int32)[idx])          # [s_pad, lw + 1]
    sh = u32.widen(sh8)[:, None]
    # sh == 0 shifts the next word out entirely (shl truncates to 32 bits)
    return u32.narrow((x[:, :-1] >> sh) | u32.shl(x[:, 1:], 32 - sh))


def repack_lanes(words: torch.Tensor, w_off: torch.Tensor, sh8: torch.Tensor,
                 lane_words: int) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise)."""
    if words.device.type == "cpu":
        return repack_lanes_plain(words, w_off, sh8, lane_words)
    kernels.check_cuda(NAME, words, torch.uint32, 1)
    kernels.check_cuda(NAME, w_off, torch.int32, 1)
    kernels.check_cuda(NAME, sh8, torch.uint32, 1)
    s_pad = w_off.shape[0]
    if sh8.shape[0] != s_pad or words.shape[0] < lane_words + 1:
        raise ValueError(f"{NAME}: bad shapes")
    out = torch.empty((s_pad, lane_words), dtype=torch.uint32,
                      device=words.device)
    kernels.launch(NAME, words.device, words.data_ptr(), words.shape[0],
                   w_off.data_ptr(), sh8.data_ptr(), out.data_ptr(), s_pad,
                   lane_words)
    return out
