"""The multi-device steps of the anchored pipeline (and the aligned v2
step) over a :class:`~dfs_tpu_torch.parallel.mesh.DeviceMesh` — the
counterparts of dfs_tpu's ``parallel/sharded_cdc.py`` ``shard_map`` steps.

Each step runs its per-slot ``local_step`` on the slot's device and, on a
card, on the slot's own stream, then gathers the slot outputs onto the
first slot's device in the layout dfs_tpu's ``out_specs`` give them. The
``shard_*`` helpers cut host inputs the way dfs_tpu's ``in_specs`` shard
them and put each piece on its slot. No step has a collective on the data
path; the JAX steps' ``psum`` of the chunk count is a sum over the slots.

- **Pass A** (:func:`make_anchored_anchor_step`): the byte-granular anchor
  pass over overlapping word spans of one region, the 8-byte lookback
  baked into each span host-side, tile positions rebased by the slot's
  offset.
- **Pass B** (:func:`make_anchored_step`): segment lanes sharded over the
  slots, each repacking (kernel 2), transposing (kernel 3), running the
  plain candidate and selection passes, then the strip SHA-256 scan
  (kernel 5).
- **The window-batched ingest steps**
  (:func:`make_anchored_window_anchor_step`,
  :func:`make_anchored_window_step`): one whole stream window per slot —
  the anchor pass, then the single-device pass-B chain (``make_segment_fn``:
  kernels 2, 3, 1 and the plain compaction) on host lane tables.
- **The aligned v2 step** (:func:`make_aligned_step`): strips sharded over
  the slots, kernel 3, plain candidates and selection, kernel 5.
- **The EC step** (:func:`make_ec_step`): erasure stripes sharded over the
  slots, P+Q by ``ops.ec.pq_horner`` (plain torch, as dfs_tpu's was XLA).
- **The sketch step** (:func:`make_sketch_step`): chunk rows sharded over
  the slots, min-hash lanes by ``sim.sketch.sketch_rows`` (plain torch, as
  dfs_tpu's was XLA).

- **The rolling steps** (:func:`make_sharded_step`,
  :func:`make_sharded_bitmap_step`): a stream's bytes tiled over sp (and
  independent streams over dp), each slot's windowed Gear bitmap taking
  the last 31 Gear values of its left sp-neighbour (dfs_tpu's
  ``ppermute``); the first step also hashes a batch of pre-padded
  messages over the slots (kernel 6), the second takes the stream's
  carry halo into sp-slot 0 (the sharded ``cdc`` ingest walk).

The parity checks hold the steps to the NumPy oracles on a toy geometry
(:func:`anchored_sharded_parity_check`, :func:`aligned_sharded_parity_check`,
:func:`rolling_sharded_parity_check`) and at production geometry
(:func:`anchored_sharded_production_check`).

``make_sharded_step``, ``make_sharded_bitmap_step`` and
``make_anchored_step`` also take a ``parallel.multihost.GlobalMesh``: a
process then runs only its own slots, the halo between processes and the
count go over ``torch.distributed`` (gloo), and the step returns this
process's slots' outputs as lists in ``mesh.local_slots`` order.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dfs_tpu_torch.config import GEAR_HALO as HALO
from dfs_tpu_torch.ops.cdc_anchored import (TILE_BYTES, AnchoredCdcParams,
                                            anchor_tiles,
                                            chunk_spans_anchored_np,
                                            kept_anchors_np, lane_tables_np,
                                            make_segment_fn, recover_m_words,
                                            region_buffer, select_segments)
from dfs_tpu_torch.ops.cdc_v2 import (BLOCK, AlignedCdcParams,
                                      candidates_np, gear_candidates,
                                      select_cuts, select_cuts_blocks)
from dfs_tpu_torch.ops.ec import pq_horner
from dfs_tpu_torch.ops.gear import gear_values, table_tensor, window_hashes
from dfs_tpu_torch.ops.layout import bswap_transpose
from dfs_tpu_torch.ops.repack import repack_lanes
from dfs_tpu_torch.ops.select import NO_ANCHOR
from dfs_tpu_torch.ops.sha256 import sha256_blocks
from dfs_tpu_torch.ops.sha256_strip import strip_states
from dfs_tpu_torch.parallel.mesh import DeviceMesh
from dfs_tpu_torch.sim.sketch import lane_tensor, sketch_rows

# ---------------------------------------------------------------------------
# slots: placement, per-slot execution, gather
# ---------------------------------------------------------------------------


def _tensor(x) -> torch.Tensor:
    """A host array (u32 stays u32, everything else int32) or a tensor."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype == np.uint32:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).view(
            torch.uint32)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _put(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device`` (uint32 moves as int32)."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).contiguous().to(device).view(torch.uint32)
    return t.contiguous().to(device)


def _local(mesh) -> tuple[DeviceMesh, list[int]]:
    """The mesh of the slots this process runs and their global indices:
    every slot of a :class:`DeviceMesh`, the own slots of a
    ``multihost.GlobalMesh``."""
    local = getattr(mesh, "local", None)
    if local is None:
        return mesh, list(range(mesh.size))
    return local, list(mesh.local_slots)


def _split(mesh, x, axis: int = 0) -> list[torch.Tensor]:
    """``x`` cut into ``mesh.size`` equal pieces along ``axis``, piece i on
    slot i (dfs_tpu's ``P(("dp", "sp"))`` sharding); only this process's
    slots' pieces."""
    t = _tensor(x)
    if t.shape[axis] % mesh.size:
        raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split "
                         f"over {mesh.size} slots")
    lm, ids = _local(mesh)
    pieces = t.chunk(mesh.size, dim=axis)
    return [_put(pieces[g], d) for g, d in zip(ids, lm.flat)]


def _replicate(mesh, x) -> list[torch.Tensor]:
    """``x`` on every slot of this process (dfs_tpu's ``P()``); slots
    sharing a device share one copy."""
    t = _tensor(x)
    copies: dict[torch.device, torch.Tensor] = {}
    flat = _local(mesh)[0].flat
    for d in flat:
        if d not in copies:
            copies[d] = _put(t, d)
    return [copies[d] for d in flat]


def _run_slots(mesh: DeviceMesh, local_step, slot_args: list) -> list:
    """``local_step(slot, *slot_args[slot])`` for the first
    ``len(slot_args)`` slots. On a card each runs on its slot's stream,
    after the work already queued on the card's current stream, and the
    current stream waits for it before anything queued later — so inputs
    made and outputs used on the current stream need no other guard."""
    devs, streams = mesh.flat, mesh.streams
    k = len(slot_args)
    if k > mesh.size:
        raise ValueError(f"{k} slot inputs for a mesh of {mesh.size}")
    for i in range(k):
        if streams[i] is not None:
            streams[i].wait_stream(torch.cuda.current_stream(devs[i]))
    outs = []
    for i, args in enumerate(slot_args):
        if streams[i] is None:
            outs.append(local_step(i, *args))
            continue
        with torch.cuda.device(devs[i]), torch.cuda.stream(streams[i]):
            outs.append(local_step(i, *args))
    for i in range(k):
        if streams[i] is not None:
            torch.cuda.current_stream(devs[i]).wait_stream(streams[i])
    return outs


def _gather(mesh: DeviceMesh, ts: list[torch.Tensor], dim: int,
            stack: bool = False) -> torch.Tensor:
    """Concatenate (or stack) slot outputs on the first slot's device."""
    dev = mesh.flat[0]
    u = ts[0].dtype == torch.uint32
    parts = [(t.view(torch.int32) if u else t).to(dev) for t in ts]
    out = torch.stack(parts, dim) if stack else torch.cat(parts, dim)
    return out.view(torch.uint32) if u else out


def _count(mesh, flags: list[torch.Tensor]) -> torch.Tensor:
    """The JAX steps' psum: the sum of every slot's local count; over a
    global mesh this process's sum is ``all_reduce``d."""
    lm, _ = _local(mesh)
    dev = lm.flat[0]
    total = torch.stack([f.sum().to(dev) for f in flags]).sum()
    if lm is mesh:
        return total
    import torch.distributed as dist

    buf = total.to("cpu", torch.int64).reshape(1)
    dist.all_reduce(buf)
    return buf[0].to(dev)


def _outputs(mesh, ts: list[torch.Tensor], dim: int):
    """Slot outputs gathered on the first slot's device, or over a global
    mesh the list of this process's slots' outputs."""
    return _gather(mesh, ts, dim) if _local(mesh)[0] is mesh else ts


def synchronize(mesh: DeviceMesh) -> None:
    """Wait for every card of the mesh (a no-op on a CPU mesh)."""
    for d in dict.fromkeys(mesh.flat):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


# ---------------------------------------------------------------------------
# the rolling steps: the Gear window crosses slot borders along sp
# ---------------------------------------------------------------------------

def _rowwise_gear_bitmap(data: torch.Tensor, prev_g: torch.Tensor,
                         table: torch.Tensor, mask: int) -> torch.Tensor:
    """data [B, S] u8, prev_g [B, 31] (the halo of each row) -> bitmap
    [B, S] bool."""
    g = gear_values(data, table)
    gp = torch.cat([prev_g.to(torch.int64), g], dim=1)
    return (window_hashes(gp, data.shape[1]) & mask) == 0


def _split_rows_cols(mesh, x) -> list[torch.Tensor]:
    """[B, S] u8 with B split over dp and S over sp (``P("dp", "sp")``);
    this process's slots' pieces."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if t.shape[0] % dp or t.shape[1] % sp:
        raise ValueError(f"{tuple(t.shape)} does not split over a "
                         f"{dp} x {sp} mesh")
    rows = t.chunk(dp, 0)
    lm, ids = _local(mesh)
    return [rows[g // sp].chunk(sp, 1)[g % sp].contiguous().to(d)
            for g, d in zip(ids, lm.flat)]


def _gather_rows_cols(mesh, ts: list[torch.Tensor]) -> torch.Tensor:
    """The inverse of :func:`_split_rows_cols` on the first slot's device
    (a one-process mesh)."""
    sp = mesh.shape["sp"]
    dev = mesh.flat[0]
    rows = [torch.cat([t.to(dev) for t in ts[r * sp:(r + 1) * sp]], 1)
            for r in range(mesh.shape["dp"])]
    return torch.cat(rows, 0)


def _left_halos(mesh, tails: list[torch.Tensor]) -> list:
    """For each slot of this process, the last 31 Gear values of its left
    sp-neighbour (None at sp 0): taken from a slot of this process, or
    received over ``torch.distributed`` (gloo) from another process, to
    which this process sends the tails its right neighbours need."""
    lm, ids = _local(mesh)
    sp = mesh.shape["sp"]
    mine = {g: i for i, g in enumerate(ids)}
    out: list = [None] * len(ids)
    remote = []
    for i, g in enumerate(ids):
        if g % sp and g - 1 in mine:
            out[i] = tails[mine[g - 1]].to(lm.flat[i])
        elif g % sp:
            remote.append(i)
    if lm is mesh:
        return out
    import torch.distributed as dist

    reqs, bufs = [], {}
    for i, g in enumerate(ids):
        if g % sp != sp - 1 and g + 1 not in mine:
            send = tails[i].to("cpu", torch.int64).contiguous()
            bufs[("send", i)] = send
            reqs.append(dist.isend(send, dst=mesh.owners[g + 1], tag=g + 1))
    for i in remote:
        g = ids[i]
        bufs[i] = torch.empty(tuple(tails[i].shape), dtype=torch.int64)
        reqs.append(dist.irecv(bufs[i], src=mesh.owners[g - 1], tag=g))
    for r in reqs:
        r.wait()
    for i in remote:
        out[i] = bufs[i].to(lm.flat[i])
    return out


def _slot_tables(mesh, table) -> dict:
    return {d: table_tensor(table, d)
            for d in dict.fromkeys(_local(mesh)[0].flat)}


def make_sharded_step(mesh, table: np.ndarray, mask: int):
    """The rolling multi-device step.

    step(data — per-slot [B/dp, S/sp] u8 (:func:`shard_inputs`), words —
    per-slot [H/n, L, 16] u32, nblocks — per-slot [H/n] i32) -> (bitmap
    [B, S] bool, digest states [H, 8] u32 (kernel 6), n_candidates — the
    global count). sp-slot 0 rolls from zeros (the stream's start)."""
    tabs = _slot_tables(mesh, table)
    lm, _ = _local(mesh)

    def local_step(slot, data, prev, words, nblocks):
        dev = lm.flat[slot]
        if prev is None:
            prev = torch.zeros((data.shape[0], HALO), dtype=torch.int64,
                               device=dev)
        return (_rowwise_gear_bitmap(data, prev, tabs[dev], mask),
                sha256_blocks(words, nblocks))

    def step(data, words, nblocks):
        tails = [gear_values(d[:, -HALO:], tabs[dev])
                 for d, dev in zip(data, lm.flat)]
        outs = _run_slots(lm, local_step, list(zip(
            data, _left_halos(mesh, tails), words, nblocks)))
        bitmap = [o[0] for o in outs]
        states = [o[1] for o in outs]
        count = _count(mesh, bitmap)
        if lm is not mesh:
            return bitmap, states, count
        return (_gather_rows_cols(mesh, bitmap), _gather(mesh, states, 0),
                count)

    return step


def make_sharded_bitmap_step(mesh, table: np.ndarray, mask: int):
    """The carry-in Gear bitmap over the mesh (the sharded ``cdc`` ingest
    walk's kernel): as :func:`make_sharded_step`'s bitmap, except that
    sp-slot 0 takes the stream's carry halo ``head`` instead of zeros, so
    consecutive regions of one stream chunk like one long buffer.

    step(data — per-slot [B/dp, S/sp] u8, head — per-slot [B/dp, 31] (the
    dp row's carry, :func:`shard_bitmap_inputs`)) -> bitmap [B, S] bool"""
    tabs = _slot_tables(mesh, table)
    lm, _ = _local(mesh)

    def local_step(slot, data, prev, head):
        return _rowwise_gear_bitmap(data, head if prev is None else prev,
                                    tabs[lm.flat[slot]], mask)

    def step(data, head):
        tails = [gear_values(d[:, -HALO:], tabs[dev])
                 for d, dev in zip(data, lm.flat)]
        bitmap = _run_slots(lm, local_step, list(zip(
            data, _left_halos(mesh, tails), head)))
        return bitmap if lm is not mesh else _gather_rows_cols(mesh, bitmap)

    return step


def shard_inputs(mesh, data, words, nblocks):
    """Rolling-step inputs: data [B, S] u8 over (dp, sp), the messages
    [H, L, 16] u32 and their block counts [H] over every slot."""
    return (_split_rows_cols(mesh, data), _split(mesh, words),
            _split(mesh, nblocks))


def shard_bitmap_inputs(mesh, data, head):
    """Carry-bitmap inputs: data [B, S] u8 over (dp, sp), head [B, 31] u32
    over dp and replicated over sp (int64 u32 values on the slots)."""
    h = torch.as_tensor(np.asarray(head, dtype=np.uint32).astype(np.int64))
    rows = h.chunk(mesh.shape["dp"], 0)
    lm, ids = _local(mesh)
    sp = mesh.shape["sp"]
    return (_split_rows_cols(mesh, data),
            [rows[g // sp].to(d) for g, d in zip(ids, lm.flat)])


# ---------------------------------------------------------------------------
# the aligned v2 step
# ---------------------------------------------------------------------------

def _cuts_and_states(words_t, real_blocks, cp: AlignedCdcParams):
    """Plain candidates + selection, then the strip scan (kernel 5)."""
    cand = gear_candidates(words_t, cp.seed, cp.mask)
    cutflag, since = select_cuts(cand, real_blocks, cp.min_blocks,
                                 cp.max_blocks)
    cf32 = cutflag.to(torch.int32)
    return cf32, since, strip_states(words_t, cf32)


def make_aligned_step(mesh: DeviceMesh, params: AlignedCdcParams):
    """Sharded **aligned CDC v2** step: strips chunk independently, so the
    strip axis shards over every slot with no halo.

    step(words_le — per-slot [S/n, bps*16] u32, real_blocks — per-slot
    [S/n] i32) -> (cutflag [bps, S] i32, states [bps*8, S] u32, n_chunks)
    """
    def local_step(slot, words_le, real_blocks):
        cf32, _, states = _cuts_and_states(bswap_transpose(words_le),
                                           real_blocks, params)
        return cf32, states

    def step(words_le, real_blocks):
        outs = _run_slots(mesh, local_step, list(zip(words_le, real_blocks)))
        cf = [o[0] for o in outs]
        return (_gather(mesh, cf, 1), _gather(mesh, [o[1] for o in outs], 1),
                _count(mesh, cf))

    return step


def shard_aligned_inputs(mesh: DeviceMesh, words_le, real_blocks):
    """Aligned-step inputs with the strip axis split over the slots."""
    return _split(mesh, words_le), _split(mesh, real_blocks)


# ---------------------------------------------------------------------------
# erasure parity, sharded: stripes are independent
# ---------------------------------------------------------------------------

def make_ec_step(mesh: DeviceMesh, k: int):
    """Multi-device P+Q encode over GF(256): the stripe axis shards over
    every slot with no exchange; each slot runs :func:`pq_horner` over its
    stripes' bytes. The JAX step's psum of the parity bytes is a sum over
    the slots.

    step(stripes — per-slot [NS/n, k, w] u32) -> (p [NS, w] u32, q [NS, w]
    u32, parity_bytes — the 2 * 4 * NS * w parity bytes, an int64 tensor)
    """
    def local_step(slot, stripes):
        ns, kk, w = stripes.shape
        p, q = pq_horner(stripes.view(torch.int32).view(torch.uint8), k,
                         axis=1)
        nbytes = torch.tensor(2 * 4 * ns * w, dtype=torch.int64,
                              device=stripes.device)
        return (p.contiguous().view(torch.int32).view(torch.uint32),
                q.contiguous().view(torch.int32).view(torch.uint32), nbytes)

    def step(stripes):
        outs = _run_slots(mesh, local_step, [(s,) for s in stripes])
        return (_gather(mesh, [o[0] for o in outs], 0),
                _gather(mesh, [o[1] for o in outs], 0),
                _count(mesh, [o[2] for o in outs]))

    return step


def shard_ec_inputs(mesh: DeviceMesh, stripes):
    """EC-step input [NS, k, w] u32 with the stripe axis split over the
    slots."""
    return _split(mesh, stripes)


# ---------------------------------------------------------------------------
# min-hash sketches, sharded: chunk rows are independent
# ---------------------------------------------------------------------------

def make_sketch_step(mesh: DeviceMesh, lanes_a, lanes_b, shingle_bytes: int):
    """Multi-device min-hash sketch step of the similarity plane: chunk
    rows shard over every slot with no exchange (a chunk's shingles never
    cross its row); each slot runs :func:`sketch_rows` over its rows. The
    lane constants are put on each slot's device once, here.

    step(blocks — per-slot [G/n, W] u8, lens — per-slot [G/n] int) ->
    sketches [G, n_lanes] u32"""
    lanes = {d: (lane_tensor(lanes_a, d), lane_tensor(lanes_b, d))
             for d in dict.fromkeys(mesh.flat)}
    devs = mesh.flat

    def local_step(slot, blocks, lens):
        a, b = lanes[devs[slot]]
        return sketch_rows(blocks, lens, a, b, shingle_bytes)

    def step(blocks, lens):
        return _gather(mesh, _run_slots(mesh, local_step,
                                        list(zip(blocks, lens))), 0)

    return step


def shard_sketch_inputs(mesh: DeviceMesh, blocks, lens):
    """Sketch-step inputs [G, W] u8 and [G] (host arrays or tensors, dtypes
    kept) with the row axis split over the slots."""
    return (_split(mesh, torch.as_tensor(blocks)),
            _split(mesh, torch.as_tensor(lens)))


def sketch_rows_fn(mesh: DeviceMesh, lanes_a, lanes_b, shingle_bytes: int):
    """``fn(blocks [R, W] u8, lens [R]) -> [R, n_lanes] u32`` over the
    mesh: the rows padded with empty rows to a multiple of the slots, then
    :func:`make_sketch_step` (what ``SimSketcher`` runs at ``devices`` >
    1)."""
    step = make_sketch_step(mesh, lanes_a, lanes_b, shingle_bytes)

    def fn(blocks, lens):
        n = blocks.shape[0]
        pad = -n % mesh.size
        if pad:
            blocks = torch.cat([blocks, blocks.new_zeros(
                (pad, blocks.shape[1]))])
            lens = torch.cat([lens, lens.new_zeros(pad)])
        return step(*shard_sketch_inputs(mesh, blocks, lens))[:n]

    return fn


# ---------------------------------------------------------------------------
# anchored, sharded: pass A over spans, pass B over segment lanes
# ---------------------------------------------------------------------------

def make_anchored_anchor_step(mesh: DeviceMesh, params: AnchoredCdcParams,
                              m_local: int):
    """Sharded **pass A**: the anchor hash is elementwise, so one region
    shards over every slot as overlapping word spans with a 2-word
    lookback (:func:`shard_anchor_inputs`); no exchange is needed.

    step(spans — per-slot [2 + m_local] u32) -> tiles [2, n_slots *
    tiles_local] i32: the first two anchor byte positions per tile,
    region-local (slot offsets added; 2**30 = none)."""
    def local_step(slot, span):
        tiles = anchor_tiles(span, params, m_local)
        return (tiles + torch.where(tiles < NO_ANCHOR, slot * m_local * 4,
                                    0)).to(torch.int32)

    def step(spans):
        return _gather(mesh, _run_slots(mesh, local_step,
                                        [(s,) for s in spans]), 1)

    return step


def shard_anchor_inputs(mesh: DeviceMesh, words, m_local: int):
    """Per-slot spans for pass A from a region buffer (2 lookback words,
    then the region): slot d gets words [d*m_local, (d+1)*m_local + 2) —
    its span plus the 8 bytes before it."""
    w = _tensor(words)
    return [_put(w[d * m_local:d * m_local + 2 + m_local], dev)
            for d, dev in enumerate(mesh.flat)]


def make_anchored_step(mesh: DeviceMesh, params: AnchoredCdcParams):
    """Sharded **pass B**: segments are independent lanes (the 64-byte grid
    restarts at each segment start), so the segment axis shards over every
    slot; the region words are replicated.

    step(words — per-slot region buffer u32, w_off/sh8/real_blocks —
    per-slot [s_pad/n]) -> (cutflag [bps, s_pad] i32, since [bps, s_pad]
    i32, states [bps*8, s_pad] u32, n_chunks)"""
    cp = params.chunk
    lane_words = cp.strip_blocks * 16

    def local_step(slot, words, w_off, sh8, real_blocks):
        words_t = bswap_transpose(repack_lanes(words, w_off, sh8,
                                               lane_words))
        return _cuts_and_states(words_t, real_blocks, cp)

    def step(words, w_off, sh8, real_blocks):
        outs = _run_slots(_local(mesh)[0], local_step,
                          list(zip(words, w_off, sh8, real_blocks)))
        cf, since, states = ([o[i] for o in outs] for i in range(3))
        return (_outputs(mesh, cf, 1), _outputs(mesh, since, 1),
                _outputs(mesh, states, 1), _count(mesh, cf))

    return step


def shard_anchored_lane_inputs(mesh: DeviceMesh, w_off, sh8, real_blocks):
    """Only the pass-B lane tables, split over the slots."""
    return (_split(mesh, w_off), _split(mesh, sh8), _split(mesh, real_blocks))


def shard_anchored_inputs(mesh: DeviceMesh, words, w_off, sh8, real_blocks):
    """Pass-B inputs: the region buffer replicated, the lane tables split."""
    return (_replicate(mesh, words),
            *shard_anchored_lane_inputs(mesh, w_off, sh8, real_blocks))


# ---------------------------------------------------------------------------
# anchored, window-batched: the ingest walk's steps, one window per slot
# ---------------------------------------------------------------------------

def make_anchored_window_anchor_step(mesh: DeviceMesh,
                                     params: AnchoredCdcParams,
                                     m_words: int):
    """Window-batched **pass A**: each slot runs the whole anchor pass over
    its own window's region buffer (lookback baked in host-side).

    step(words — one region buffer per slot, up to ``mesh.size``) -> tiles
    [B, 2, m_tiles] i32 (window-local positions)."""
    def local_step(slot, words):
        return anchor_tiles(words, params, m_words)

    def step(words):
        return _gather(mesh, _run_slots(mesh, local_step,
                                        [(w,) for w in words]), 0,
                       stack=True)

    return step


def make_anchored_window_step(mesh: DeviceMesh, params: AnchoredCdcParams,
                              total_words: int, s_pad: int):
    """Window-batched **pass B**: each slot runs the single-device segment
    chain (``ops.cdc_anchored.make_segment_fn`` at cap_mode 'full' — a
    streaming walk must never need an overflow redo) on its own window and
    returns that window's finished chunk table.

    step(words — one region buffer per slot, w_off/sh8/real_blocks/
    tail_len/starts/seg_lens — per-slot [s_pad], see
    :func:`shard_window_rows`) -> (count [B] i32, q [B, c_max] i32, offs
    [B, c_max] i32, lens [B, c_max] i32, digests [B, c_max, 8] u32); row b
    is window b's chunk table in stream order, rows past count garbage."""
    segment = make_segment_fn(params, recover_m_words(total_words, params),
                              s_pad, "full")

    def local_step(slot, *args):
        return segment(*args)

    def step(words, *tables):
        outs = _run_slots(mesh, local_step, list(zip(words, *tables)))
        return tuple(_gather(mesh, [o[i] for o in outs], 0, stack=True)
                     for i in range(5))

    return step


def shard_window_rows(mesh: DeviceMesh, *tables):
    """[B, s_pad] host tables -> per-table lists, row b on slot b."""
    out = []
    for x in tables:
        t = _tensor(x)
        out.append([_put(t[b], mesh.flat[b]) for b in range(t.shape[0])])
    return tuple(out)


# ---------------------------------------------------------------------------
# oracles and parity checks
# ---------------------------------------------------------------------------

def host_lane_descriptors(data: np.ndarray, params: AnchoredCdcParams,
                          pad_multiple: int):
    """Whole-stream host segment selection and pass-B lane tables (the
    layout from ``lane_tables_np``). Returns (starts, bounds, seg_lens,
    w_off, sh8, real_blocks, s_real)."""
    n = int(data.shape[0])
    bounds = select_segments(kept_anchors_np(data, params), n, params)
    starts = np.concatenate([[0], bounds[:-1]])
    seg_lens = bounds - starts
    s_real = starts.shape[0]
    s_pad = -(-s_real // pad_multiple) * pad_multiple
    _, _, w_off, sh8, real_blocks, _ = lane_tables_np(bounds, 0, s_pad)
    return starts, bounds, seg_lens, w_off, sh8, real_blocks, s_real


def expected_segment_cutflags(data: np.ndarray, starts, bounds,
                              params: AnchoredCdcParams) -> np.ndarray:
    """Per-segment oracle cutflags [bps, s_real] (NumPy candidates + greedy
    selection per segment)."""
    bps = params.chunk.strip_blocks
    out = np.zeros((bps, len(starts)), np.int32)
    for i in range(len(starts)):
        seg = data[int(starts[i]):int(bounds[i])]
        nb = -(-seg.shape[0] // BLOCK)
        pos = np.flatnonzero(candidates_np(seg, params.chunk))
        out[select_cuts_blocks(pos, nb, params.chunk) - 1, i] = 1
    return out


def _expected_tiles(kept: np.ndarray, m_words: int) -> np.ndarray:
    """The pass-A tile table the oracle's kept anchors imply."""
    tiles = np.full((2, m_words * 4 // TILE_BYTES), NO_ANCHOR, np.int32)
    for p in kept:                  # first two per tile, sorted
        t = int(p) // TILE_BYTES
        tiles[0 if tiles[0, t] == NO_ANCHOR else 1, t] = int(p)
    return tiles


def _anchored_passes_check(mesh: DeviceMesh, params: AnchoredCdcParams,
                           data: np.ndarray, lane_multiple: int,
                           what: str) -> dict:
    """Both sharded anchored passes over ``data`` (one region split evenly
    over the slots), held to the NumPy oracles: pass-A tiles == the kept
    anchors, pass-B cutflags == per-segment selection, the count == the
    cutflag population, and the spans rebuilt from the cutflags == the
    whole-stream oracle. Returns shapes and the passes' wall times."""
    n_dev = mesh.size
    m_words = data.shape[0] // 4
    if m_words % n_dev or (m_words // n_dev * 4) % TILE_BYTES:
        raise ValueError("the region must split into tile-aligned spans")
    m_local = m_words // n_dev
    words = region_buffer(data, np.zeros((8,), np.uint8), params,
                          m_words=m_words)
    rec: dict = {"region_bytes": int(data.shape[0]), "n_devices": n_dev,
                 "m_local_words": m_local,
                 "tiles_per_device": m_local * 4 // TILE_BYTES}

    astep = make_anchored_anchor_step(mesh, params, m_local)
    spans = shard_anchor_inputs(mesh, words, m_local)
    synchronize(mesh)
    t0 = time.perf_counter()
    tiles = astep(spans)
    synchronize(mesh)
    rec["pass_a_s"] = time.perf_counter() - t0
    kept = kept_anchors_np(data, params)
    if not np.array_equal(tiles.cpu().numpy(), _expected_tiles(kept,
                                                               m_words)):
        raise AssertionError(f"{what} sharded pass A tile mismatch")
    rec["kept_anchors"] = int(kept.shape[0])

    (starts, bounds, seg_lens, w_off, sh8, real_blocks,
     s_real) = host_lane_descriptors(data, params, lane_multiple)
    if w_off.shape[0] % n_dev:
        raise AssertionError(
            f"lane table {w_off.shape[0]} not divisible by {n_dev}")
    rec["segments"] = int(s_real)
    rec["lane_table"] = int(w_off.shape[0])

    bstep = make_anchored_step(mesh, params)
    binp = shard_anchored_inputs(mesh, words, w_off, sh8, real_blocks)
    synchronize(mesh)
    t0 = time.perf_counter()
    cf, _since, _states, n_chunks = bstep(*binp)
    synchronize(mesh)
    rec["pass_b_s"] = time.perf_counter() - t0
    cf = cf.cpu().numpy()
    if not np.array_equal(cf[:, :s_real], expected_segment_cutflags(
            data, starts, bounds, params)):
        raise AssertionError(f"{what} sharded cutflag mismatch")
    if int(n_chunks) != int(cf.sum()):
        raise AssertionError(f"{what} sharded chunk count mismatch")
    rec["chunks"] = int(n_chunks)

    spans_got = []
    for i in range(s_real):
        ln = int(seg_lens[i])
        prev = 0
        for c in (np.flatnonzero(cf[:, i]) + 1).tolist():
            end = min(c * BLOCK, ln)
            spans_got.append((int(starts[i]) + prev * BLOCK,
                              end - prev * BLOCK))
            prev = c
    if spans_got != chunk_spans_anchored_np(data, params):
        raise AssertionError(f"{what} sharded spans != oracle spans")
    return rec


def anchored_sharded_parity_check(mesh: DeviceMesh, n_devices: int) -> dict:
    """Both sharded anchored passes on a toy stream (4 KiB lanes, 2-4 KiB
    segments, 4 tiles per slot) against the NumPy oracles — the geometry
    of dfs_tpu's check of the same name."""
    if mesh.size != n_devices:
        raise ValueError(f"mesh has {mesh.size} slots, not {n_devices}")
    params = AnchoredCdcParams(
        chunk=AlignedCdcParams(min_blocks=2, avg_blocks=4, max_blocks=16,
                               strip_blocks=64),        # 4 KiB lanes
        seg_min=2048, seg_max=4096, seg_mask=2047)
    n = 4 * TILE_BYTES * n_devices                      # 4 tiles per slot
    data = np.random.default_rng(11).integers(0, 256, size=n,
                                              dtype=np.uint8)
    return _anchored_passes_check(mesh, params, data, n_devices, "anchored")


def anchored_sharded_production_check(mesh: DeviceMesh, n_devices: int,
                                      region_bytes: int = 64 * 2**20
                                      ) -> dict:
    """The same check at production geometry: a full 64 MiB region,
    default AnchoredCdcParams (96-128 KiB segments, 128 KiB lanes), lane
    tables padded to 128 — the shapes the single-device chain runs.
    Returns a record with the passes' wall times (host clock around work
    that ends in a synchronize)."""
    if mesh.size != n_devices:
        raise ValueError(f"mesh has {mesh.size} slots, not {n_devices}")
    params = AnchoredCdcParams()
    n = (region_bytes // TILE_BYTES) * TILE_BYTES
    data = np.random.default_rng(23).integers(0, 256, size=n,
                                              dtype=np.uint8)
    rec = _anchored_passes_check(mesh, params, data, 128, "production")
    rec["params"] = {"seg_min": params.seg_min, "seg_max": params.seg_max,
                     "strip_blocks": params.chunk.strip_blocks,
                     "lane_multiple": 128}
    return rec


def aligned_sharded_parity_check(mesh: DeviceMesh, n_devices: int) -> None:
    """One sharded aligned step (2 strips of 2 KiB per slot): cutflags must
    match the NumPy oracle and the count their population — the check
    dfs_tpu's multichip dryrun runs on its aligned step."""
    if mesh.size != n_devices:
        raise ValueError(f"mesh has {mesh.size} slots, not {n_devices}")
    params = AlignedCdcParams(min_blocks=2, avg_blocks=4, max_blocks=16,
                              strip_blocks=32)        # 2 KiB strips
    s = 2 * n_devices
    strip_len = params.strip_blocks * BLOCK
    raw = np.random.default_rng(7).integers(0, 256, size=s * strip_len,
                                            dtype=np.uint8)
    words_le = raw.view("<u4").reshape(s, params.strip_blocks * 16)
    real_blocks = np.full((s,), params.strip_blocks, np.int32)

    step = make_aligned_step(mesh, params)
    cf, _states, n = step(*shard_aligned_inputs(mesh, words_le, real_blocks))
    cf = cf.cpu().numpy()
    cand = candidates_np(raw, params)
    for i in range(s):
        pos = np.flatnonzero(
            cand[i * params.strip_blocks:(i + 1) * params.strip_blocks])
        expect = np.zeros((params.strip_blocks,), np.int32)
        expect[select_cuts_blocks(pos, params.strip_blocks, params) - 1] = 1
        if not np.array_equal(cf[:, i], expect):
            raise AssertionError(f"aligned sharded cutflag mismatch, "
                                 f"strip {i}")
    if int(n) != int(cf.sum()):
        raise AssertionError("aligned chunk count mismatch")


def rolling_sharded_parity_check(mesh, params, data: np.ndarray,
                                 messages: list) -> dict:
    """One :func:`make_sharded_step` over ``data`` [B, S] u8 and the
    messages: each row's bitmap == the NumPy Gear bitmap of the row, the
    count == its population, the states == hashlib's digests. A
    one-process mesh only (a global mesh checks its own slots)."""
    import hashlib

    from dfs_tpu_torch.fragmenter.cdc_cpu import gear_bitmap_numpy
    from dfs_tpu_torch.ops.sha256 import pad_messages, state_to_hex
    from dfs_tpu_torch.utils.hashing import gear_table

    table = gear_table(params.seed)
    words, nblocks = pad_messages(
        messages, batch=-(-len(messages) // mesh.size) * mesh.size)
    step = make_sharded_step(mesh, table, params.mask)
    bitmap, states, count = step(*shard_inputs(mesh, data, words, nblocks))
    bitmap = bitmap.cpu().numpy()
    want = np.stack([gear_bitmap_numpy(row, table, params.mask)
                     for row in data])
    if not np.array_equal(bitmap, want):
        raise AssertionError("rolling sharded bitmap != numpy oracle")
    if int(count) != int(want.sum()):
        raise AssertionError("rolling sharded candidate count mismatch")
    if state_to_hex(states)[:len(messages)] != [
            hashlib.sha256(m).hexdigest() for m in messages]:
        raise AssertionError("rolling sharded digests != hashlib")
    return {"rows": int(data.shape[0]), "row_bytes": int(data.shape[1]),
            "candidates": int(count), "messages": len(messages)}
