"""The anchored walk window-batched over a device mesh — the counterpart
of dfs_tpu's ``fragmenter/cdc_anchored_sharded.py``.

The fixed-stride window schedule of ``AnchoredCudaFragmenter`` (windows
advance by ``region_bytes - seg_max``), with whole windows riding the
mesh's slots, one per slot, so a batch of ``devices`` windows chunks and
hashes at once (``parallel/sharded_cdc``'s window steps):

- **pass A, batched**: the anchor pass per window, the 8-byte lookback
  baked in host-side. Its ``[2, m_tiles]`` tile tables come to the host:
  the only sync between the passes.
- **segment selection on the host** (``select_segments``, the oracle's
  own function) with the carry threaded as the single-device walk threads
  it: ``start0 = consumed - stride``. The carry needs only pass A and the
  selection, so pass B of a batch never waits on it.
- **pass B, batched**: each slot runs the single-device segment chain on
  its window's lane tables and returns a finished chunk table.

Up to ``staging_buffers`` batches are in flight: the next batch's windows
are filled and copied to their slots (on a copy stream per card) while
earlier batches compute. A partial last batch simply runs fewer slots.
The ragged tail runs the single-device chain (``region_chunks``) on the
first slot. Output is byte-identical to the single-device walk and the
NumPy oracle for every region and carry geometry.

Host staging buffers return to the pool only when their batch has been
collected: on a CPU slot the region tensor aliases the buffer, and on a
card the batch's copies are long done by then.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from dfs_tpu_torch.config import FragmenterConfig
from dfs_tpu_torch.fragmenter.cdc_anchored import (_REGION_BYTES,
                                                   _AnchoredBase, _lookback)
from dfs_tpu_torch.fragmenter.sharded_common import (ShardedSteps,
                                                     fixed_region_bytes)
from dfs_tpu_torch.meta.manifest import ChunkRef
from dfs_tpu_torch.ops.cdc_anchored import (TILE_BYTES, AnchoredCdcParams,
                                            lane_tables_np, region_buffer,
                                            region_buffer_size, region_chunks,
                                            select_segments, words_tensor)
from dfs_tpu_torch.ops.cdc_v2 import digests_to_hex
from dfs_tpu_torch.ops.select import NO_ANCHOR
from dfs_tpu_torch.parallel.sharded_cdc import (
    make_anchored_window_anchor_step, make_anchored_window_step,
    shard_window_rows)


class ShardedAnchoredCudaFragmenter(_AnchoredBase):
    """The window-batched walk over ``frag.devices`` slots. ``device``
    picks them (``parallel.mesh.make_mesh``): None = one slot per visible
    card (raises when fewer cards are visible than configured), "cpu" = CPU
    slots running the plain versions, a list = those slots (a card may
    repeat)."""

    name = "cdc-anchored-cuda"

    def __init__(self, params: AnchoredCdcParams | None = None,
                 frag: FragmenterConfig | None = None, device=None) -> None:
        frag = frag or FragmenterConfig(devices=2)
        self.devices = max(1, int(frag.devices))
        # the default window splits the single-device walk's 64 MiB across
        # the batch: a batch stages the bytes of one single-device window
        super().__init__(params, region_bytes=fixed_region_bytes(
            frag.region_bytes, _REGION_BYTES // self.devices, TILE_BYTES))
        self.staging_buffers = int(frag.staging_buffers)
        self._m_words = self.region_bytes // 4
        self._total_words = region_buffer_size(
            self.region_bytes, self.params, m_words=self._m_words) // 4
        # the worst-case segment count of a window: one lane table shape
        self._s_pad = self.region_bytes // self.params.seg_min + 1
        # windows ride dp: one whole window per slot
        self._steps = ShardedSteps(self.devices, self._build,
                                   dp=self.devices, device=device)
        self.mesh = self._steps.mesh
        self._pinned = any(d.type == "cuda" for d in self.mesh.flat)
        self._buf_pool: list[torch.Tensor] = []
        self._copy_streams: dict[torch.device, torch.cuda.Stream] = {}

    def _build(self, mesh):
        return (make_anchored_window_anchor_step(mesh, self.params,
                                                 self._m_words),
                make_anchored_window_step(mesh, self.params,
                                          self._total_words, self._s_pad))

    # ---- staging ----

    def _pool_take(self) -> torch.Tensor:
        try:
            return self._buf_pool.pop()
        except IndexError:
            return torch.empty((self._total_words * 4,), dtype=torch.uint8,
                               pin_memory=self._pinned)

    def _put(self, host: torch.Tensor, dev: torch.device) -> torch.Tensor:
        """A staged region buffer on slot device ``dev`` as u32 words. On a
        card the copy runs on the card's copy stream, and the card's current
        stream (which every step's slot streams wait on) waits for it."""
        if dev.type == "cpu":
            return words_tensor(host.numpy())       # aliases the buffer
        copy = self._copy_streams.get(dev)
        if copy is None:
            copy = self._copy_streams[dev] = torch.cuda.Stream(device=dev)
        with torch.cuda.device(dev), torch.cuda.stream(copy):
            words = torch.empty_like(host, device=dev)
            words.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy)
        torch.cuda.current_stream(dev).wait_event(done)
        return words.view(torch.int32).view(torch.uint32)

    # ---- the window-batched walk ----

    def chunks_stream(self, blocks, store=None):
        """Bounded-memory batched streaming: the single-device walk's window
        schedule and carry, windows staged one per slot, up to
        ``staging_buffers`` batches in flight. The host buffer trims to the
        oldest un-emitted window's base minus the lookback. Yields each
        window's ChunkRefs as a batch."""
        astep, bstep = self._steps.get()
        devs = self.mesh.flat
        nb = self.devices
        buf = bytearray()
        buf_base = 0                   # absolute offset of buf[0]
        total = 0                      # absolute bytes received
        base = 0                       # next window base to stage
        start0 = 0                     # carry (window-local), host int
        idx = 0
        staged: list[tuple] = []       # [(base, device words, host buffer)]
        # [(recs, outputs, host buffers, device words)]; recs: per window
        # (base, start0, consumed)
        pending: collections.deque = collections.deque()

        def fetch(off: int, ln: int) -> np.ndarray:
            if off < buf_base:
                raise AssertionError(
                    f"stream buffer trimmed past {off} (base {buf_base})")
            return np.frombuffer(buf, np.uint8, count=ln,
                                 offset=off - buf_base)

        def emit(chunks, b0: int) -> list[ChunkRef]:
            nonlocal idx
            out = []
            for o, ln, dg in chunks:
                off = b0 + o
                if store is not None:
                    store(dg, fetch(off, ln).tobytes())
                out.append(ChunkRef(index=idx, offset=off, length=ln,
                                    digest=dg))
                idx += 1
            return out

        def trim() -> None:
            # un-collected batches hold the oldest un-emitted windows
            nonlocal buf_base
            oldest = base
            if staged:
                oldest = min(oldest, staged[0][0])
            if pending:
                oldest = min(oldest, pending[0][0][0][0])
            keep_from = max(buf_base, oldest - 8)
            if keep_from > buf_base:
                del buf[:keep_from - buf_base]
                buf_base = keep_from

        def stage(b: int) -> None:
            host = self._pool_take()
            region_buffer(fetch(b, self.region_bytes), _lookback(fetch, b),
                          self.params, m_words=self._m_words,
                          out=host.numpy())
            staged.append((b, self._put(host, devs[len(staged)]), host))

        def launch() -> None:
            """Batched pass A, the host selection threading the carry, then
            batched pass B enqueued."""
            nonlocal start0
            words = [w for _, w, _ in staged]
            tiles = astep(words).cpu().numpy()      # the only sync
            tables = np.zeros((6, len(staged), self._s_pad), np.int64)
            recs = []
            for i, (b, _, _) in enumerate(staged):
                t = tiles[i]
                anchors = np.sort(t[t < NO_ANCHOR].astype(np.int64))
                bounds = select_segments(anchors, self.region_bytes,
                                         self.params, start0=start0,
                                         final=False)
                tables[:, i] = lane_tables_np(bounds, start0, self._s_pad)
                consumed = int(bounds[-1]) if bounds.size else int(start0)
                recs.append((b, int(start0), consumed))
                start0 = consumed - self.stride
            starts, seg_lens, w_off, sh8, rb, tail = tables
            out = bstep(words, *shard_window_rows(
                self.mesh, w_off.astype(np.int32), sh8.astype(np.uint32),
                rb.astype(np.int32), tail.astype(np.int32),
                starts.astype(np.int32), seg_lens.astype(np.int32)))
            pending.append((recs, out, [h for _, _, h in staged], words))
            staged.clear()

        def collect() -> list[list[ChunkRef]]:
            """Pull the oldest batch and emit its windows in stream order,
            checking span contiguity against the carry chain."""
            recs, out, hosts, _ = pending.popleft()
            counts, q, offs, lens, dig = (t.cpu() for t in out)
            self._buf_pool.extend(hosts)            # the batch is done
            batches = []
            for i, (b, s0, consumed) in enumerate(recs):
                k = int(counts[i])
                if k > q.shape[1]:
                    raise AssertionError(
                        f"{k} cuts > full capacity {q.shape[1]}")
                if k and bool((q[i, :k] < 0).any()):
                    raise AssertionError(
                        "anchored cut compaction overflowed a tile")
                hexes = digests_to_hex(dig[i, :k].view(torch.int32).numpy()
                                       .view(np.uint32))
                chunks = []
                expect = s0
                for o, ln, h in zip(offs[i, :k].tolist(),
                                    lens[i, :k].tolist(), hexes):
                    if o != expect:
                        raise AssertionError(
                            f"sharded anchored walk discontinuity at {o} "
                            f"(want {expect})")
                    expect = o + ln
                    chunks.append((o, ln, h))
                if expect != consumed:
                    raise AssertionError(
                        f"sharded window ended at {expect} != {consumed}")
                batch = emit(chunks, b)
                if batch:
                    batches.append(batch)
            return batches

        for blk in blocks:
            buf += blk
            total += len(blk)
            while total - base >= self.region_bytes:
                if not staged:
                    # the in-flight gate sits at batch start:
                    # staging_buffers=1 is strictly serial staging
                    while len(pending) >= self.staging_buffers:
                        yield from collect()
                stage(base)
                base += self.stride
                if len(staged) == nb:
                    launch()
                trim()
        if staged:
            while len(pending) >= self.staging_buffers:
                yield from collect()
            launch()
        while pending:
            yield from collect()
            trim()
        # the ragged tail (after any window, at least seg_max bytes):
        # the single-device chain on the first slot
        n_tail = total - base
        if n_tail > 0:
            chunks, consumed = region_chunks(
                fetch(base, n_tail), _lookback(fetch, base), start0, True,
                self.params, device=devs[0])
            if base + consumed != total:
                raise AssertionError(
                    f"sharded anchored stream ended at {base + consumed} "
                    f"!= {total}")
            batch = emit(chunks, base)
            if batch:
                yield batch

    def chunk(self, data) -> list[ChunkRef]:
        return [c for batch in self.chunks_stream([data]) for c in batch]

    def stream_span(self) -> int | None:
        # up to staging_buffers batches of `devices` windows in flight,
        # the batch being staged and the window being filled
        return self.region_bytes * (
            self.devices * (self.staging_buffers + 1) + 1)
