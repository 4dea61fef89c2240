"""Batched min-hash sketches of chunks (the port of dfs_tpu's
``sim/sketch.py`` and of the sketch math of its ``make_sketch_step``).

A chunk's sketch is ``sketch_size`` uint32 lanes: the rolling polynomial
hash of every ``shingle_bytes``-byte shingle, permuted per lane
(``h * a_k + b_k``, odd ``a_k``), min-reduced over the chunk. Similar
chunks share shingles, so their lane minima agree with probability equal
to their shingle-set Jaccard similarity; grouped into bands
(:func:`band_keys`) that becomes an index lookup.

Two implementations of the same math, byte-identical:

- :func:`sketch_np`, the NumPy oracle (a copy of dfs_tpu's), which also
  sketches chunks longer than the window, as in dfs_tpu;
- :func:`sketch_rows`, plain PyTorch on any device (dfs_tpu's was XLA, not
  Pallas). u32 values ride in ``int64`` masked to 32 bits
  (:mod:`dfs_tpu_torch.utils.u32`), the same code on the CPU and the card.

:class:`SimSketcher` is what the node runs: every chunk of a batch that
fits the window in one host-to-device copy, rows grouped by padded length
(:class:`SketchPlan`), one copy back. It sketches on the node's device at
every ``SimConfig.devices`` value (dfs_tpu runs the oracle on the host at
0 or 1) and over ``devices`` slots when > 1
(:func:`dfs_tpu_torch.parallel.sharded_cdc.make_sketch_step`).
"""

from __future__ import annotations

import numpy as np
import torch

from dfs_tpu_torch import resolve_device
from dfs_tpu_torch.config import SimConfig
from dfs_tpu_torch.fragmenter.sharded_common import fixed_region_bytes
from dfs_tpu_torch.ops.ec import _pad_bucket
from dfs_tpu_torch.utils.u32 import M32, narrow

EMPTY_LANE = 0xFFFFFFFF        # a lane with no shingles (len < q)
_MULT = 0x01000193             # FNV-1a prime: the shingle-hash multiplier
_WINDOW_DEFAULT = 64 * 1024    # the CDC max-chunk bound
_GRANULE = 256
_U64 = (1 << 64) - 1
# int64 elements of one [rows, lanes, positions] tile of sketch_rows
_TILE_ELEMS = 1 << 24


def lane_constants(n_lanes: int, seed: int = 0x5349) -> tuple[np.ndarray,
                                                              np.ndarray]:
    """Per-lane (a, b) permutation constants, splitmix64-derived from
    ``seed``: deterministic across hosts and packages (sketches must agree
    cluster-wide), ``a`` forced odd so ``h -> h*a+b`` is a bijection on
    uint32."""
    a = np.empty(n_lanes, np.uint32)
    b = np.empty(n_lanes, np.uint32)
    x = seed & _U64
    for i in range(n_lanes):
        x = (x + 0x9E3779B97F4A7C15) & _U64
        z = x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
        z ^= z >> 31
        a[i] = (z & 0xFFFFFFFF) | 1
        b[i] = (z >> 32) & 0xFFFFFFFF
    return a, b


def sketch_np(data: bytes | np.ndarray, n_lanes: int, shingle_bytes: int,
              lanes_a: np.ndarray, lanes_b: np.ndarray) -> np.ndarray:
    """The host oracle: ``[n_lanes]`` uint32 min-hash lanes of ``data``.
    A chunk shorter than one shingle has no features: every lane is
    :data:`EMPTY_LANE`."""
    arr = data if isinstance(data, np.ndarray) \
        else np.frombuffer(data, dtype=np.uint8)
    n = arr.shape[0] - shingle_bytes + 1
    if n <= 0:
        return np.full(n_lanes, EMPTY_LANE, np.uint32)
    b = arr.astype(np.uint32)
    h = np.zeros(n, np.uint32)
    mult = np.uint32(_MULT)
    for j in range(shingle_bytes):
        h = h * mult + b[j:j + n]
    vals = h[None, :] * lanes_a[:, None] + lanes_b[:, None]
    return vals.min(axis=1)


def band_keys(sketch: np.ndarray, bands: int) -> list[int]:
    """The LSH band keys of one sketch: each band of ``n_lanes // bands``
    lanes folds (FNV-style, python-int mod 2^64) into one 64-bit key,
    salted by the band index so equal lane values in different bands never
    collide. An empty sketch (no shingles) has no keys."""
    if sketch[0] == EMPTY_LANE and (sketch == EMPTY_LANE).all():
        return []
    r = sketch.shape[0] // bands
    keys = []
    for t in range(bands):
        h = ((t + 1) * 0x9E3779B97F4A7C15) & _U64
        for v in sketch[t * r:(t + 1) * r]:
            h = ((h ^ int(v)) * 0x100000001B3) & _U64
        keys.append(h)
    return keys


def lane_tensor(x, device) -> torch.Tensor:
    """u32 lane constants (a numpy array, or an int64 tensor from an
    earlier call) as int64 on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.asarray(x, dtype=np.uint32).astype(
        np.int64)).to(device)


def sketch_rows(blocks: torch.Tensor, lens: torch.Tensor, lanes_a, lanes_b,
                shingle_bytes: int) -> torch.Tensor:
    """Min-hash sketches of ``R`` zero-padded rows, on their device.

    blocks [R, W] uint8, lens [R] int (each <= W) -> [R, n_lanes] uint32,
    equal to :func:`sketch_np` of ``blocks[i, :lens[i]]``. Positions at or
    past ``lens[i] - shingle_bytes + 1`` are masked to :data:`EMPTY_LANE`
    (the penalty ORs 0xFFFFFFFF in), so the zero padding changes nothing.
    The ``[rows, lanes, positions]`` values never exist whole: the rows and
    positions are cut into tiles of at most ``_TILE_ELEMS`` values, each
    reduced into a running minimum, as dfs_tpu's ``fori_loop`` does.

    The lane permutation is exact in int64: with ``a = a_hi * 2^16 +
    a_lo``, ``h * a = h * a_lo + (h mod 2^16) * (a_hi << 16)  (mod 2^32)``
    and both products stay below 2^48."""
    dev = blocks.device
    a = lane_tensor(lanes_a, dev)
    b = lane_tensor(lanes_b, dev).view(1, -1, 1)
    a_lo = (a & 0xFFFF).view(1, -1, 1)
    a_hi = ((a >> 16) << 16).view(1, -1, 1)
    n_lanes = a.shape[0]
    r, w = blocks.shape
    n_pos = w - shingle_bytes + 1
    out = torch.full((r, n_lanes), EMPTY_LANE, dtype=torch.int64, device=dev)
    if r == 0 or n_pos <= 0:
        return narrow(out)
    valid = (lens.to(device=dev, dtype=torch.int64)
             - shingle_bytes + 1).clamp(min=0).view(-1, 1)
    rows_per = max(1, min(r, _TILE_ELEMS // (n_lanes * min(n_pos, 512))))
    for r0 in range(0, r, rows_per):
        rb = blocks[r0:r0 + rows_per]
        nr = rb.shape[0]
        tile = max(1, min(n_pos, _TILE_ELEMS // (nr * n_lanes)))
        acc = out[r0:r0 + nr]
        for t0 in range(0, n_pos, tile):
            t = min(tile, n_pos - t0)
            x = rb[:, t0:t0 + t + shingle_bytes - 1].to(torch.int64)
            h = torch.zeros((nr, t), dtype=torch.int64, device=dev)
            for j in range(shingle_bytes):
                h.mul_(_MULT).add_(x[:, j:j + t]).bitwise_and_(M32)
            pos = torch.arange(t0, t0 + t, device=dev).view(1, -1)
            pen = torch.where(pos < valid[r0:r0 + nr], 0, M32).unsqueeze(1)
            vals = h.unsqueeze(1) * a_lo
            vals += (h & 0xFFFF).unsqueeze(1) * a_hi
            vals += b
            vals.bitwise_and_(M32).bitwise_or_(pen)
            torch.minimum(acc, vals.amin(dim=2), out=acc)
    return narrow(out)


class SketchPlan:
    """Where each row of a batched sketch lies: rows grouped by padded
    width (``ops.ec``'s bucket rule, zero padding under 25%, and never
    narrower than one shingle), each group a contiguous ``[n, width]``
    block of one packed host buffer that starts with the rows' int32
    lengths in group order. The packed order of the rows is ``order``."""

    def __init__(self, lens: list[int], shingle_bytes: int) -> None:
        self.shingle_bytes = int(shingle_bytes)
        keyed: dict[int, list[int]] = {}
        for i, ln in enumerate(lens):
            keyed.setdefault(max(_pad_bucket(ln), self.shingle_bytes),
                             []).append(i)
        self.lens = [int(ln) for ln in lens]
        self.order: list[int] = []
        self.groups: list[tuple[int, int, int, int]] = []  # width, n, row0, off
        off = 4 * len(lens)
        for width, idxs in sorted(keyed.items()):
            self.groups.append((width, len(idxs), len(self.order), off))
            self.order.extend(idxs)
            off += len(idxs) * width
        self.nbytes = off
        self.data_bytes = sum(self.lens)
        # positions computed (padding included) and the unpadded ones
        self.positions = sum(n * max(0, w - self.shingle_bytes + 1)
                             for w, n, _, _ in self.groups)
        self.live_positions = sum(max(0, ln - self.shingle_bytes + 1)
                                  for ln in self.lens)

    def pack(self, datas) -> np.ndarray:
        """The packed host buffer: lengths, then each group's rows."""
        host = np.zeros(self.nbytes, dtype=np.uint8)
        host[:4 * len(self.lens)].view(np.int32)[:] = \
            [self.lens[i] for i in self.order]
        for width, n, row0, off in self.groups:
            blk = host[off:off + n * width].reshape(n, width)
            for r, i in enumerate(self.order[row0:row0 + n]):
                blk[r, :self.lens[i]] = np.frombuffer(datas[i], np.uint8)
        return host

    def sketch(self, packed: torch.Tensor, rows_fn) -> torch.Tensor:
        """[rows, n_lanes] uint32 in packed order from the packed buffer on
        its device: ``rows_fn(blocks, lens)`` (:func:`sketch_rows` with the
        lanes bound, or the sharded step) once per group."""
        lens = packed[:4 * len(self.lens)].view(torch.int32)
        outs = [rows_fn(packed[off:off + n * width].view(n, width),
                        lens[row0:row0 + n])
                for width, n, row0, off in self.groups]
        return torch.cat([o.view(torch.int32) for o in outs]).view(
            torch.uint32)


class SimSketcher:
    """The batched sketch front end of the plane: sketches on ``device``
    (None: the card, raising without one), over ``cfg.devices`` slots when
    > 1 (one slot per card on the card, CPU slots on the CPU; raises when
    the cards are not there). Output is identical to :func:`sketch_np`."""

    def __init__(self, cfg: SimConfig, window_bytes: int = 0,
                 device=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.window = fixed_region_bytes(window_bytes, _WINDOW_DEFAULT,
                                         _GRANULE)
        self.lanes_a, self.lanes_b = lane_constants(cfg.sketch_size)
        self.devices = max(1, int(cfg.devices))
        if self.devices > 1:
            from dfs_tpu_torch.parallel.mesh import make_mesh
            from dfs_tpu_torch.parallel.sharded_cdc import sketch_rows_fn

            mesh = make_mesh(self.devices, device=None
                             if self.device.type == "cuda" else self.device)
            self._rows_fn = sketch_rows_fn(mesh, self.lanes_a, self.lanes_b,
                                           cfg.shingle_bytes)
        else:
            a = lane_tensor(self.lanes_a, self.device)
            b = lane_tensor(self.lanes_b, self.device)
            q = cfg.shingle_bytes
            self._rows_fn = lambda blk, ln: sketch_rows(blk, ln, a, b, q)

    def sketch_one(self, data: bytes) -> np.ndarray:
        return self.sketch_many([data])[0]

    def sketch_many(self, datas) -> np.ndarray:
        """Sketches of a batch of chunks, ``[len(datas), sketch_size]``
        uint32. The chunks that fit the window go to the device in one
        host-to-device copy of a :class:`SketchPlan` buffer owned by this
        call, and come back in one copy, on the calling thread's current
        stream; longer chunks take :func:`sketch_np`, as in dfs_tpu."""
        n = len(datas)
        out = np.empty((n, self.cfg.sketch_size), np.uint32)
        dev_idx = []
        for i, d in enumerate(datas):
            if len(d) <= self.window:
                dev_idx.append(i)
            else:
                out[i] = sketch_np(np.frombuffer(d, np.uint8),
                                   self.cfg.sketch_size,
                                   self.cfg.shingle_bytes, self.lanes_a,
                                   self.lanes_b)
        if dev_idx:
            sub = [datas[i] for i in dev_idx]
            plan = SketchPlan([len(d) for d in sub], self.cfg.shingle_bytes)
            packed = torch.from_numpy(plan.pack(sub)).to(self.device)
            got = plan.sketch(packed, self._rows_fn).view(
                torch.int32).cpu().numpy()
            out[np.asarray(dev_idx)[plan.order]] = got.view(np.uint32)
        return out
