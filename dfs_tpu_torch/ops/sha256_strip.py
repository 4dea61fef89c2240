"""Kernels 1 and 5: the strip SHA-256 scans.

Kernel 1 — fused Gear candidates + greedy cut selection + strip SHA-256.

Replaces ``dfs_tpu/ops/sha256_strip.py:strip_chunk_states`` (Pallas body
``_strip_fused_kernel``). One pass over the lane-minor words computes, per
lane and block in order: the Gear window hash of words 8..15, the cut
decision, and the SHA-256 compression of the block, emitting the
post-block state and resetting the chain to H0 after a cut.

CUDA design (``csrc/strip_chunk_states.cu``): one thread per lane, the
Gear counter, ``since`` and the 8-word SHA state in registers, a loop over
the lane's ``bps`` blocks. The lane-minor layout makes every word load and
state store coalesced across a warp. What bounds it on this card: the work
is ~2,400 dependent 32-bit integer operations per block-lane and only
``S`` (~640) threads exist, so it is latency bound far above both the
byte and the operation bound — a later redesign (parallel candidates, then
per-chunk SHA) is what would fill the card.

Plain version: :func:`strip_chunk_states_plain` — ``ops.cdc_v2``'s
``gear_candidates`` + ``select_cuts`` + :func:`strip_states_plain`, the
same three-stage twin the JAX tests pin the Pallas kernel to.

Kernel 5 — the strip SHA-256 scan with the cuts given. Replaces
``dfs_tpu/ops/sha256_strip.py:strip_states`` (Pallas body
``_strip_kernel``), which the multi-device steps run after their plain
candidate and selection passes (``parallel.sharded_cdc``): every lane
chains its blocks, emits the post-block state, and restarts from H0 after
a flagged block. CUDA design (``csrc/strip_states.cu``): kernel 1 without
the Gear and selection work, sharing its compression
(``csrc/sha256_compress.cuh``); the same latency bound. It takes any lane
count, and the card never takes the plain version for it.

Plain version: :func:`strip_states_plain` (``ops.sha256.strip_states``,
the ``strip_states_xla`` twin).
"""

from __future__ import annotations

import torch

from dfs_tpu_torch import kernels
from dfs_tpu_torch.ops import cdc_v2
from dfs_tpu_torch.ops import sha256

NAME = "strip_chunk_states"
NAME_K5 = "strip_states"

strip_states_plain = sha256.strip_states


def strip_chunk_states_plain(words_t: torch.Tensor, real_blocks: torch.Tensor,
                             seed: int, mask: int, min_b: int, max_b: int
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(words_t [bps*16, S] u32 BE, real_blocks [S] i32) -> (cutflag
    [bps, S] i32, since [bps, S] i32, states [bps*8, S] u32)."""
    cand = cdc_v2.gear_candidates(words_t, seed, mask)
    cutflag, since = cdc_v2.select_cuts(cand, real_blocks, min_b, max_b)
    cf32 = cutflag.to(torch.int32)
    return cf32, since, strip_states_plain(words_t, cf32)


def strip_chunk_states(words_t: torch.Tensor, real_blocks: torch.Tensor,
                       seed: int, mask: int, min_b: int, max_b: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused pass. CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise)."""
    if words_t.device.type == "cpu":
        return strip_chunk_states_plain(words_t, real_blocks, seed, mask,
                                        min_b, max_b)
    kernels.check_cuda(NAME, words_t, torch.uint32, 2)
    kernels.check_cuda(NAME, real_blocks, torch.int32, 1)
    rows, s = words_t.shape
    if rows % 16 or real_blocks.shape[0] != s:
        raise ValueError(f"{NAME}: bad shapes {tuple(words_t.shape)}, "
                         f"{tuple(real_blocks.shape)}")
    bps = rows // 16
    dev = words_t.device
    cutflag = torch.empty((bps, s), dtype=torch.int32, device=dev)
    since = torch.empty((bps, s), dtype=torch.int32, device=dev)
    states = torch.empty((bps * 8, s), dtype=torch.uint32, device=dev)
    kernels.launch(NAME, dev, words_t.data_ptr(), real_blocks.data_ptr(),
                   cutflag.data_ptr(), since.data_ptr(), states.data_ptr(),
                   bps, s, seed & 0xFFFFFFFF, mask & 0xFFFFFFFF, min_b, max_b)
    return cutflag, since, states


def strip_states(words_t: torch.Tensor, cutflag: torch.Tensor
                 ) -> torch.Tensor:
    """(words_t [bps*16, S] u32 BE, cutflag [bps, S] i32) -> states
    [bps*8, S] u32. CPU tensors take the plain version; CUDA tensors
    launch kernel 5 (or raise)."""
    if words_t.device.type == "cpu":
        return strip_states_plain(words_t, cutflag)
    kernels.check_cuda(NAME_K5, words_t, torch.uint32, 2)
    kernels.check_cuda(NAME_K5, cutflag, torch.int32, 2)
    rows, s = words_t.shape
    if rows % 16 or tuple(cutflag.shape) != (rows // 16, s) \
            or cutflag.device != words_t.device:
        raise ValueError(f"{NAME_K5}: bad shapes {tuple(words_t.shape)}, "
                         f"{tuple(cutflag.shape)}")
    bps = rows // 16
    dev = words_t.device
    states = torch.empty((bps * 8, s), dtype=torch.uint32, device=dev)
    kernels.launch(NAME_K5, dev, words_t.data_ptr(), cutflag.data_ptr(),
                   states.data_ptr(), bps, s)
    return states
