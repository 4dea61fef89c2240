"""Kernels 1 and 5: the strip SHA-256 scans.

Kernel 1 — Gear candidates + greedy cut selection + strip SHA-256.

Replaces ``dfs_tpu/ops/sha256_strip.py:strip_chunk_states`` (Pallas body
``_strip_fused_kernel``): per lane, the Gear window hash of words 8..15 of
every block, the greedy cut decision, and the SHA-256 chain of each chunk,
emitting the post-block state and restarting from H0 after a cut.

CUDA design (``csrc/strip_chunk_states.cu``): two kernels per call. The
selection kernel (one CTA per 8 lanes, fewer where a lane's two bitmaps
are large) hashes the Gear windows of all blocks in parallel into per-lane
candidate bitmaps (the bytes looked up in a 256-entry table built from
``seed``) and lets one warp per lane jump from cut to cut over its bitmap,
writing ``cutflag`` and ``since``. The chain kernel
(``csrc/strip_chunks.cuh``) then chains every chunk in its own thread: a
consumer warp runs only the rounds, a producer warp prefetches the blocks
and computes their message schedules into shared memory, a storer warp
writes the states, and each CTA packs its chunks longest first into just
enough slots. What bounds it on this card: the longest chunk's chain of
compressions (at most ``max_blocks``) at the INT32 issue rate of one SM
scheduler, and the scattered 32-byte sectors that the lane-minor layout
gives each block; not bytes or operations.

**Two layouts** (:func:`plan_strip`). The narrow one, which the default
geometry takes, keeps a CTA's chunk lists in shared memory with 16-bit
fields. Lanes past 65,536 blocks, or lists past the 16-bit ranks, take the
wide one: 20-bit block fields, the lists in a device scratch of
:meth:`StripPlan.scratch_words`, a selection CTA of
:func:`wide_select_lanes` lanes. It takes lanes of up to 2^20 blocks (64
MiB) for kernel 5 and of up to 925,184 blocks for kernel 1, whose
selection CTA holds two bitmaps a lane: every lane dfs_tpu's anchored
walk makes (up to 32 MiB, 2^19 blocks, in its default 64 MiB region), and
restic's and Borg's 8 MiB chunks. Past that :func:`check_geometry` raises.

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

import dataclasses

import torch

from dfs_tpu_torch import kernels
from dfs_tpu_torch.ops import cdc_v2
from dfs_tpu_torch.ops import sha256

NAME = "strip_chunk_states"
NAME_K5 = "strip_states"

strip_states_plain = sha256.strip_states

# Shared-memory geometry of the kernels (csrc/strip_chunks.cuh,
# csrc/strip_chunk_states.cu): the selection CTA holds two bitmaps of bps
# bits for each of its lanes (SELECT_LANES with the narrow layout); a chain
# CTA holds the W+K and state double buffers, per-slot lists, per lane a
# flag bitmap and, in the narrow layout only, up to `cap` chunks with
# 16-bit fields.
SELECT_LANES = 8
MAX_SHARED = 232448          # bytes a CTA may opt in to on this card
MAX_CHUNKS = 65534           # narrow: chunks per chain CTA (16-bit ranks)
MAX_NARROW_BLOCKS = 65536    # narrow: 16-bit block fields
MAX_WIDE_BLOCKS = 1 << 20    # wide: 20-bit block fields
SELECT_STATIC = 1152         # the selection CTA's static shared memory
CHAIN_STATIC = 16            # the chain CTA's, counted in the wide layout
_CLASSES = 32                # wide: length classes of the ranking
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


def chain_shared_bytes(lanes: int, cap: int, bps: int,
                       wide: bool = False) -> int:
    """Shared memory of a chain CTA of ``lanes`` lanes of ``bps`` blocks
    with at most ``cap`` chunks a lane (the wide layout's lists are in
    device memory)."""
    fixed = _CHAIN_FIXED_BYTES + lanes * (12 + -(-bps // 32) * 4)
    if wide:
        return fixed + 2 * _CLASSES * 4
    chunks = lanes * cap
    return fixed + chunks * 4 + 2 * (-(-chunks * 2 // 4) * 4)


def select_shared_bytes(bps: int, lanes: int = SELECT_LANES) -> int:
    """Shared memory of kernel 1's selection CTA of ``lanes`` lanes."""
    return 2 * lanes * -(-bps // 32) * 4


def narrow_fits(bps: int, cap: int, select: bool = False) -> bool:
    """Whether the narrow layout takes lanes of ``bps`` blocks with up to
    ``cap`` chunks (``select``: kernel 1's 8-lane selection CTA too)."""
    need = max(select_shared_bytes(bps) if select else 0,
               chain_shared_bytes(1, cap, bps))
    return (need <= MAX_SHARED and cap <= MAX_CHUNKS
            and bps <= MAX_NARROW_BLOCKS)


def wide_select_lanes(bps: int) -> int:
    """Lanes of a wide-layout selection CTA: as many of the 8 as shared
    memory holds two bitmaps for (0: not one)."""
    return min(SELECT_LANES, (MAX_SHARED - SELECT_STATIC)
               // select_shared_bytes(bps, 1))


def check_geometry(name: str, bps: int, cap: int,
                   select: bool = False) -> None:
    """Raise unless the kernels take a lane of ``bps`` blocks with up to
    ``cap`` chunks in one of their layouts: the wide layout's 20-bit block
    fields, one lane's flag bitmap in a chain CTA and (``select``: kernel
    1) its two bitmaps in a selection CTA."""
    chain = chain_shared_bytes(1, cap, bps, wide=True) + CHAIN_STATIC
    sel = select_shared_bytes(bps, 1) + SELECT_STATIC if select else 0
    if bps < 1 or cap < 1:
        raise ValueError(f"{name}: bps={bps}, cap={cap}")
    if bps > MAX_WIDE_BLOCKS:
        raise ValueError(f"{name}: a lane of bps={bps} blocks is past the "
                         f"block fields' {MAX_WIDE_BLOCKS}")
    if max(chain, sel) > MAX_SHARED:
        raise ValueError(f"{name}: a lane of bps={bps} blocks needs "
                         f"{max(chain, sel)} B of shared memory per CTA (at "
                         f"most {MAX_SHARED})")


@dataclasses.dataclass(frozen=True)
class StripPlan:
    """How kernels 1 and 5 lay out a launch: the chain kernel's layout,
    the selection CTA's lanes (kernel 1) and the list entries a lane."""
    wide: bool
    select_lanes: int
    cap: int

    def scratch_words(self, lanes: int) -> int:
        """The wide layout's list scratch (u32 words) for ``lanes``
        lanes: three words a list entry."""
        return 3 * lanes * self.cap if self.wide else 0


def plan_strip(name: str, bps: int, cap: int, select: bool = False,
               layout: str | None = None,
               select_lanes: int | None = None) -> StripPlan:
    """The layout of a launch on lanes of ``bps`` blocks with up to
    ``cap`` chunks a lane: narrow where it fits, else wide
    (:func:`check_geometry` raises past both). ``layout`` ("narrow" or
    "wide") and ``select_lanes`` (wide only, 1-8) force a choice, so that
    the two layouts can be held against each other at a small geometry."""
    check_geometry(name, bps, cap, select)
    if layout not in (None, "narrow", "wide"):
        raise ValueError(f"{name}: layout must be 'narrow' or 'wide'")
    fits = narrow_fits(bps, cap, select)
    wide = not fits if layout is None else layout == "wide"
    if not wide and not fits:
        raise ValueError(f"{name}: the narrow layout cannot take bps={bps} "
                         f"with up to {cap} chunks a lane")
    lanes = SELECT_LANES
    if wide and select:
        lanes = wide_select_lanes(bps) if select_lanes is None \
            else int(select_lanes)
        if not 1 <= lanes <= min(SELECT_LANES, wide_select_lanes(bps)):
            raise ValueError(f"{name}: {lanes} selection lanes at "
                             f"bps={bps}")
    elif select_lanes not in (None, SELECT_LANES):
        raise ValueError(f"{name}: the narrow layout selects 8 lanes a CTA")
    return StripPlan(wide=wide, select_lanes=lanes, cap=cap)


def _scratch(plan: StripPlan, lanes: int, dev) -> torch.Tensor | None:
    if not plan.wide:
        return None
    return torch.empty((plan.scratch_words(lanes),), dtype=torch.int32,
                       device=dev)


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
                       seed: int, mask: int, min_b: int, max_b: int, *,
                       layout: str | None = None,
                       select_lanes: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 1. CPU tensors take the plain version; CUDA tensors launch
    the kernel (or raise), whose states are 0 on dead rows. The layout is
    :func:`plan_strip`'s (``layout``/``select_lanes`` force one); a
    geometry the kernels cannot take raises (:func:`check_geometry`)."""
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
    plan = plan_strip(NAME, bps, list_capacity(bps, min_b, max_b), True,
                      layout, select_lanes)
    dev = words_t.device
    cutflag = torch.empty((bps, s), dtype=torch.int32, device=dev)
    since = torch.empty((bps, s), dtype=torch.int32, device=dev)
    states = torch.empty((bps * 8, s), dtype=torch.uint32, device=dev)
    scratch = _scratch(plan, s, dev)
    kernels.launch(NAME, dev, words_t.data_ptr(), real_blocks.data_ptr(),
                   cutflag.data_ptr(), since.data_ptr(), states.data_ptr(),
                   bps, s, seed & 0xFFFFFFFF, mask & 0xFFFFFFFF, min_b, max_b,
                   plan.select_lanes, int(plan.wide),
                   None if scratch is None else scratch.data_ptr())
    return cutflag, since, states


def strip_states(words_t: torch.Tensor, cutflag: torch.Tensor, *,
                 layout: str | None = None) -> torch.Tensor:
    """(words_t [bps*16, S] u32 BE, cutflag [bps, S] i32) -> states
    [bps*8, S] u32. CPU tensors take the plain version; CUDA tensors
    launch kernel 5 (or raise), whose states are 0 on dead rows. Any flag
    may be set, so a lane's list is sized for ``bps`` chunks; ``layout``
    forces one (:func:`plan_strip`)."""
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
    plan = plan_strip(NAME_K5, bps, bps, False, layout)
    dev = words_t.device
    states = torch.empty((bps * 8, s), dtype=torch.uint32, device=dev)
    scratch = _scratch(plan, s, dev)
    kernels.launch(NAME_K5, dev, words_t.data_ptr(), cutflag.data_ptr(),
                   states.data_ptr(), bps, s, int(plan.wide),
                   None if scratch is None else scratch.data_ptr())
    return states
