"""Anchored two-level CDC fragmenters.

Chunking is identical whether the stream is chunked whole, in any
batching, or streamed: each window hands the device a tile-aligned region
with 8 bytes of lookback, and the unfinished tail segment carries into the
next window (``ops.cdc_anchored.region_chunks``).

The CUDA walk is **pipelined**: windows advance by a fixed tile-aligned
stride (``region_bytes - seg_max`` — far enough that the carry always lands
inside the next window), so every window's bytes are known up front and
window k+1 is staged while window k computes. The carry position chains as
a CUDA tensor (``consumed_k - stride``), so a multi-window stream runs with
no host sync until a window's results are collected. Host staging buffers
are pinned and recycled; a buffer returns to the pool only once the copy
that read it has completed.

- ``AnchoredCpuFragmenter`` — the host engine (the C++ core of
  ``native/``), equal to the NumPy oracle (``chunk_file_anchored_np``,
  ``region_spans_np``), the reference semantics.
- ``AnchoredCudaFragmenter`` — the device chain, bounded-memory streaming
  in windows of ``region_bytes``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from dfs_tpu_torch import resolve_device
from dfs_tpu_torch.fragmenter.base import Fragmenter
from dfs_tpu_torch.meta.manifest import ChunkRef
from dfs_tpu_torch.ops.cdc_anchored import (TILE_BYTES, AnchoredCdcParams,
                                            CutCapacityOverflow,
                                            chunk_file_anchored_np,
                                            region_buffer, region_buffer_size,
                                            region_chunks, region_collect,
                                            region_dispatch, words_tensor)
from dfs_tpu_torch.utils.hashing import sha256_hex

_REGION_BYTES = 64 * 1024 * 1024
_CPU_CUTOFF = 2 * 1024 * 1024


def _to_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return data
    return np.frombuffer(data, dtype=np.uint8)


def _lookback(fetch, base: int) -> np.ndarray:
    """The 8 stream bytes before ``base`` (zeros before the stream)."""
    lb = np.zeros((8,), np.uint8)
    take = min(8, base)
    if take:
        lb[8 - take:] = fetch(base - take, take)
    return lb


class _AnchoredBase(Fragmenter):
    def __init__(self, params: AnchoredCdcParams | None = None,
                 region_bytes: int = _REGION_BYTES) -> None:
        self.params = params or AnchoredCdcParams()
        region_bytes = (int(region_bytes) // TILE_BYTES) * TILE_BYTES
        if region_bytes < 2 * self.params.seg_max:
            raise ValueError("region must hold at least two segments")
        self.region_bytes = region_bytes
        # fixed window stride: the previous window's carry (>= window end
        # - seg_max) always lands inside the next window
        self.stride = region_bytes - self.params.seg_max

    def describe(self) -> dict:
        p, c = self.params, self.params.chunk
        return {"kind": "cdc-anchored",
                "chunk": {"min_blocks": c.min_blocks,
                          "avg_blocks": c.avg_blocks,
                          "max_blocks": c.max_blocks,
                          "strip_blocks": c.strip_blocks, "seed": c.seed},
                "seg_min": p.seg_min, "seg_max": p.seg_max,
                "seg_mask": p.seg_mask, "seed": p.seed}


class AnchoredCpuFragmenter(_AnchoredBase):
    """The host engine, dfs_tpu's ``cdc-anchored``: spans from the C++ core
    (``native/cdc_core.cpp`` ``dfs_anchored_spans`` for a whole stream,
    ``dfs_anchored_spans_region`` for each window of the same fixed-stride
    walk as the CUDA engine), digests from hashlib. Equal to the NumPy
    oracle (``chunk_file_anchored_np``, ``region_spans_np``); a failed g++
    build raises (dfs_tpu falls back to the oracle)."""

    name = "cdc-anchored"

    def chunk(self, data: bytes) -> list[ChunkRef]:
        from dfs_tpu_torch.native import native_anchored_spans

        arr = np.ascontiguousarray(_to_u8(data))
        mv = memoryview(arr)
        return [ChunkRef(index=i, offset=o, length=ln,
                         digest=sha256_hex(mv[o:o + ln]))
                for i, (o, ln) in enumerate(
                    native_anchored_spans(arr, self.params).tolist())]

    def stream_span(self) -> int | None:
        # one window resident; the carry can reach seg_max behind its base
        return self.region_bytes + self.params.seg_max

    def chunks_stream(self, blocks, store=None):
        """Bounded-memory streaming on the host; output equals chunk() for
        any blocking (the window contract guarantees it)."""
        buf = bytearray()
        buf_base = 0                    # absolute offset of buf[0]
        total = 0
        base = 0                        # current window base (absolute)
        start0 = 0                      # carry, window-local
        idx = 0

        def fetch(off: int, ln: int) -> np.ndarray:
            return np.frombuffer(buf, np.uint8, count=ln,
                                 offset=off - buf_base)

        def window(n: int, final: bool) -> list[ChunkRef]:
            nonlocal base, start0, buf_base, idx
            from dfs_tpu_torch.native import native_anchored_spans_region

            arr = fetch(base, n)
            spans, consumed = native_anchored_spans_region(
                arr, _lookback(fetch, base), start0, final, self.params)
            del arr                     # release before the bytearray trim
            out = []
            for o, ln in spans.tolist():
                off = base + o
                payload = bytes(buf[off - buf_base:off - buf_base + ln])
                dg = sha256_hex(payload)
                out.append(ChunkRef(index=idx, offset=off, length=ln,
                                    digest=dg))
                idx += 1
                if store is not None:
                    store(dg, payload)
            if not final:
                start0 = consumed - self.stride
                base += self.stride
                keep_from = base - 8
                if keep_from > buf_base:
                    del buf[:keep_from - buf_base]
                    buf_base = keep_from
            return out

        for blk in blocks:
            buf += blk
            total += len(blk)
            while total - base >= self.region_bytes:
                batch = window(self.region_bytes, final=False)
                if batch:
                    yield batch
        if total - base > 0 or total == 0:
            batch = window(total - base, final=True)
            if batch:
                yield batch


class AnchoredCudaFragmenter(_AnchoredBase):
    """The device pipeline, window-batched; output is batching-independent.
    ``device`` defaults to the CUDA card (raises without one); pass
    ``device="cpu"`` to run the same walk through the plain versions."""

    name = "cdc-anchored-cuda"

    def __init__(self, params: AnchoredCdcParams | None = None,
                 region_bytes: int = _REGION_BYTES,
                 cpu_cutoff: int = _CPU_CUTOFF,
                 lane_multiple: int = 128,
                 max_inflight: int = 2,
                 device=None) -> None:
        super().__init__(params, region_bytes)
        self.device = resolve_device(device)
        self.cpu_cutoff = int(cpu_cutoff)
        self.lane_multiple = int(lane_multiple)
        self.max_inflight = max(1, int(max_inflight))
        self._cuda = self.device.type == "cuda"
        # recycled host staging buffers (pinned on CUDA), keyed by size.
        # A node runs concurrent uploads' walks in worker threads on one
        # fragmenter: each walk keeps its own windows, carry and device
        # tensors, and issues them on its thread's current stream; the
        # pool is the state they share, taken and returned under a lock
        self._buf_pool: dict[int, list[torch.Tensor]] = {}
        self._pool_lock = threading.Lock()
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda \
            else None

    # -- staging ----------------------------------------------------------

    def _pool_take(self, size: int) -> torch.Tensor:
        with self._pool_lock:
            free = self._buf_pool.get(size)
            if free:
                return free.pop()
        return torch.empty((size,), dtype=torch.uint8, pin_memory=self._cuda)

    def _pool_give(self, host: torch.Tensor, copied) -> None:
        """Return a staging buffer once the copy that read it is done."""
        if copied is not None:
            copied.synchronize()
        with self._pool_lock:
            self._buf_pool.setdefault(host.shape[0], []).append(host)

    def _stage(self, data: np.ndarray, lookback: np.ndarray):
        """Fill a pooled host buffer with the region layout and put it on
        the device. Returns (device words u32, host buffer, copy event)."""
        host = self._pool_take(region_buffer_size(data.shape[0],
                                                  self.params))
        region_buffer(data, lookback, self.params, out=host.numpy())
        if not self._cuda:
            # plain versions run eagerly: the chain has read the buffer
            # before dispatch returns, so it can be used in place
            return words_tensor(host.numpy().view("<u4")), host, None
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            dev = torch.empty_like(host, device=self.device)
            dev.copy_(host, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        compute.wait_event(copied)
        dev.record_stream(compute)     # freed only after the chain used it
        return dev.view(torch.int32).view(torch.uint32), host, copied

    # -- pipelined window walk shared by chunk() and chunks_stream() ------

    def _dispatch_window(self, fetch, base: int, n: int, start0,
                         final: bool) -> tuple:
        """Stage window [base, min(n, base+region_bytes)) and enqueue the
        chain. ``fetch(off, ln)`` returns stream bytes for any span inside
        [base-8, end). ``final`` is explicit: inferring it from end == n
        would misfire when the bytes received so far happen to end exactly
        on a window end."""
        end = min(n, base + self.region_bytes)
        words, host, copied = self._stage(fetch(base, end - base),
                                          _lookback(fetch, base))
        out = region_dispatch(words, end - base, start0, final, self.params,
                              lane_multiple=self.lane_multiple)
        return base, end, final, out, host, copied

    def _collect_window(self, base: int, end: int, final: bool, out, host,
                        copied, fetch, chunks: list[ChunkRef], store) -> int:
        """Pull one window's results and append absolute-offset ChunkRefs;
        returns the absolute consumed bound. Verifies span contiguity (the
        device-chained carry has no per-window host check)."""
        expect = chunks[-1].offset + chunks[-1].length if chunks else 0
        try:
            spans, consumed = region_collect(out)
        except CutCapacityOverflow:
            # content denser than the tight provisioning: redo this window
            # alone at the full bound. The carry later windows chained on
            # is exact regardless (the select walk runs at the full bound)
            spans, consumed = region_chunks(
                fetch(base, end - base), _lookback(fetch, base),
                expect - base, final, self.params,
                lane_multiple=self.lane_multiple, cap_mode="full",
                device=self.device)
        self._pool_give(host, copied)
        for o, ln, dg in spans:
            off = base + o
            if off != expect:
                raise AssertionError(
                    f"anchored walk discontinuity at {off} (want {expect})")
            expect = off + ln
            chunks.append(ChunkRef(index=len(chunks), offset=off, length=ln,
                                   digest=dg))
            if store is not None:
                store(dg, fetch(off, ln).tobytes())
        return base + consumed

    def _oracle(self, arr: np.ndarray, store=None) -> list[ChunkRef]:
        out = [ChunkRef(index=i, offset=o, length=ln, digest=dg)
               for i, (o, ln, dg) in
               enumerate(chunk_file_anchored_np(arr, self.params))]
        if store is not None:
            for c in out:
                store(c.digest, arr[c.offset:c.offset + c.length].tobytes())
        return out

    def _walk(self, arr: np.ndarray, store=None) -> list[ChunkRef]:
        n = int(arr.shape[0])
        if n == 0:
            return []
        if n <= self.cpu_cutoff:
            return self._oracle(arr, store)
        fetch = lambda off, ln: arr[off:off + ln]       # noqa: E731
        chunks: list[ChunkRef] = []
        pending: list[tuple] = []
        start0 = 0                     # int for window 0, device tensor after
        base = 0
        while True:
            if len(pending) >= self.max_inflight:       # cap live windows
                self._collect_window(*pending.pop(0), fetch, chunks, store)
            final = base + self.region_bytes >= n
            win = self._dispatch_window(fetch, base, n, start0, final)
            pending.append(win)
            if final:
                break
            start0 = win[3][0] - self.stride            # device carry
            base += self.stride
        bound = 0
        for win in pending:
            bound = self._collect_window(*win, fetch, chunks, store)
        if bound != n:
            raise AssertionError(f"anchored walk ended at {bound} != {n}")
        return chunks

    def chunk(self, data: bytes) -> list[ChunkRef]:
        return self._walk(_to_u8(data))

    def stream_span(self) -> int | None:
        # up to max_inflight windows dispatched-but-uncollected plus the
        # one being filled
        return self.region_bytes * (self.max_inflight + 1)

    def chunks_stream(self, blocks, store=None):
        """Bounded-memory pipelined streaming: the same window schedule and
        device-chained carry as chunk(), dispatching each full window as
        soon as its bytes arrive while up to ``max_inflight`` windows
        compute. The host buffer is trimmed to the oldest uncollected
        window's base minus the lookback, so peak memory is about
        (max_inflight + 1) windows regardless of stream length. Yields
        each collected window's ChunkRefs as a batch."""
        chunks: list[ChunkRef] = []
        buf = bytearray()
        buf_base = 0                   # absolute offset of buf[0]
        total = 0                      # absolute bytes received
        pending: list[tuple] = []
        start0 = 0
        base = 0
        done = False

        def fetch(off: int, ln: int) -> np.ndarray:
            if off < buf_base:
                raise AssertionError(
                    f"stream buffer trimmed past {off} (base {buf_base})")
            return np.frombuffer(buf, np.uint8, count=ln,
                                 offset=off - buf_base)

        def trim() -> None:
            nonlocal buf_base
            oldest = pending[0][0] if pending else base
            keep_from = max(buf_base, oldest - 8)
            if keep_from > buf_base:
                del buf[:keep_from - buf_base]
                buf_base = keep_from

        def collect_one():
            n0 = len(chunks)
            bound = self._collect_window(*pending.pop(0), fetch, chunks,
                                         store)
            return bound, chunks[n0:]

        def advance(n_known: int, final_ok: bool):
            """Dispatch every window whose bytes are fully buffered; yields
            a batch per collected window."""
            nonlocal base, start0, done
            while not done:
                full = base + self.region_bytes <= n_known
                final = final_ok and base + self.region_bytes >= n_known
                if not (full or final):
                    return
                if len(pending) >= self.max_inflight:
                    _, batch = collect_one()
                    if batch:
                        yield batch
                win = self._dispatch_window(fetch, base, n_known, start0,
                                            final)
                pending.append(win)
                trim()
                if final:
                    done = True
                    return
                start0 = win[3][0] - self.stride
                base += self.stride

        for blk in blocks:
            buf += blk
            total += len(blk)
            yield from advance(total, final_ok=False)
        if total == 0:
            return
        if total <= self.cpu_cutoff and not pending and base == 0:
            # small streams take chunk()'s oracle path (identical output)
            out = self._oracle(np.frombuffer(buf, np.uint8), store)
            if out:
                yield out
            return
        yield from advance(total, final_ok=True)
        bound = 0
        while pending:
            bound, batch = collect_one()
            trim()
            if batch:
                yield batch
        if bound != total:
            raise AssertionError(
                f"anchored stream ended at {bound} != {total}")
