"""Kernels 1 and 5: the strip SHA-256 scans.

Kernel 1 — Gear candidates + greedy cut selection + strip SHA-256.

Replaces ``dfs_tpu/ops/sha256_strip.py:strip_chunk_states`` (Pallas body
``_strip_fused_kernel``): per lane, the Gear window hash of words 8..15 of
every block, the greedy cut decision, and the SHA-256 chain of each chunk,
emitting the post-block state and restarting from H0 after a cut.

CUDA design (``csrc/strip_chunk_states.cu``): two kernels per call. The
selection kernel (one CTA per 8 lanes) hashes the Gear windows of all
blocks in parallel into per-lane candidate bitmaps (the bytes looked up in
a 256-entry table built from ``seed``) and lets one warp per lane jump
from cut to cut over its bitmap, writing ``cutflag`` and ``since``. The
chain kernel (``csrc/strip_chunks.cuh``) then chains every chunk in its own
thread: a consumer warp runs only the rounds, a producer warp prefetches
the blocks and computes their message schedules into shared memory, a
storer warp writes the states, and each CTA packs its chunks longest first
into just enough slots. What bounds it on this card: the longest chunk's
chain of compressions (at most ``max_blocks``) at the INT32 issue rate of
one SM scheduler, and the scattered 32-byte sectors that the lane-minor
layout gives each block; not bytes or operations.

**Live rows.** A lane's live rows are the blocks ``t <=`` its last flagged
block; for kernel 1 that is ``t < real_blocks``. No consumer reads a state
after a lane's last cut (``ops.cdc_anchored.compact_half`` gathers cut rows
and the row before a lane's last block; the sharded steps drop the states),
so both kernels compute the states of the live rows and store 0 in the
others. ``cutflag`` and ``since`` are exact on every row. The plain versions
chain every row, as the JAX reference does; :func:`live_state_rows` and
:func:`zero_dead_states` compare the two.

Plain version: :func:`strip_chunk_states_plain` — ``ops.cdc_v2``'s
``gear_candidates`` + ``select_cuts`` + :func:`strip_states_plain`, the
same three-stage twin the JAX tests pin the Pallas kernel to.

Kernel 5 — the strip SHA-256 scan with the cuts given. Replaces
``dfs_tpu/ops/sha256_strip.py:strip_states`` (Pallas body
``_strip_kernel``), which the multi-device steps run after their plain
candidate and selection passes (``parallel.sharded_cdc``). CUDA design
(``csrc/strip_states.cu``): kernel 1's chain kernel alone, which reads each
lane's chunk list from the given flags. The same bound and the same
live-row contract. It takes any lane count, and the card never takes the
plain version for it.

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

# Shared-memory geometry of the kernels (csrc/strip_chunks.cuh,
# csrc/strip_chunk_states.cu): the selection CTA holds two bitmaps of bps
# bits for each of its SELECT_LANES lanes; a chain CTA holds the W+K and
# state double buffers, per-slot lists, and per lane a flag bitmap and up
# to `cap` chunks with 16-bit fields.
SELECT_LANES = 8
MAX_SHARED = 232448          # bytes a CTA may opt in to on this card
MAX_CHUNKS = 65534           # chunks per chain CTA (16-bit ranks)
_CHAIN_FIXED_BYTES = 2 * 16 * 32 * 16 + 2 * 2 * 32 * 16 + 32 * 8


def live_state_rows(cutflag: torch.Tensor) -> torch.Tensor:
    """[bps, S] bool: row t of lane s is live iff the lane has a flag at
    some row >= t, i.e. t <= the lane's last flagged block."""
    flags = (cutflag != 0).to(torch.int32)
    return flags.flip(0).cumsum(0).flip(0) > 0


def zero_dead_states(states: torch.Tensor, cutflag: torch.Tensor
                     ) -> torch.Tensor:
    """A copy of ``states`` [bps*8, S] with the 8 words of every dead row
    (:func:`live_state_rows`) set to 0 — what the kernels store there."""
    bps, s = cutflag.shape
    v = states.view(torch.int32) if states.dtype == torch.uint32 else states
    out = v.reshape(bps, 8, s).masked_fill(
        ~live_state_rows(cutflag)[:, None, :], 0).reshape(bps * 8, s)
    return out.view(torch.uint32) if states.dtype == torch.uint32 else out


def list_capacity(bps: int, min_b: int, max_b: int) -> int:
    """Chunks a lane can have under kernel 1's selection: every chunk but
    the lane's last is at least min(min_b, max_b) blocks long."""
    shortest = max(1, min(min_b, max_b))
    return -(-bps // shortest) + 1


def chain_shared_bytes(lanes: int, cap: int, bps: int) -> int:
    """Shared memory of a chain CTA of ``lanes`` lanes of ``bps`` blocks
    with at most ``cap`` chunks a lane."""
    chunks = lanes * cap
    return (_CHAIN_FIXED_BYTES + lanes * (12 + -(-bps // 32) * 4)
            + chunks * 4 + 2 * (-(-chunks * 2 // 4) * 4))


def select_shared_bytes(bps: int) -> int:
    """Shared memory of kernel 1's selection CTA."""
    return 2 * SELECT_LANES * -(-bps // 32) * 4


def check_geometry(name: str, bps: int, cap: int,
                   select_bytes: int = 0) -> None:
    """Raise unless the kernels take a lane of ``bps`` blocks with up to
    ``cap`` chunks: one lane must fit a chain CTA, block indices and chunk
    counts must fit their 16-bit fields."""
    need = max(select_bytes, chain_shared_bytes(1, cap, bps))
    if need > MAX_SHARED or cap > MAX_CHUNKS or bps > 65536:
        raise ValueError(f"{name}: bps={bps} with up to {cap} chunks a lane "
                         f"needs {need} B of shared memory per CTA (at most "
                         f"{MAX_SHARED}) and {cap} chunk slots (at most "
                         f"{MAX_CHUNKS})")


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
    """Kernel 1. CPU tensors take the plain version; CUDA tensors launch
    the kernel (or raise), whose states are 0 on dead rows. A geometry
    the kernels cannot take raises (:func:`check_geometry`)."""
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
    check_geometry(NAME, bps, list_capacity(bps, min_b, max_b),
                   select_shared_bytes(bps))
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
    launch kernel 5 (or raise), whose states are 0 on dead rows."""
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
    check_geometry(NAME_K5, bps, bps)
    dev = words_t.device
    states = torch.empty((bps * 8, s), dtype=torch.uint32, device=dev)
    kernels.launch(NAME_K5, dev, words_t.data_ptr(), cutflag.data_ptr(),
                   states.data_ptr(), bps, s)
    return states
