"""Erasure coding: RAID-6-style P+Q parity over GF(256) — the port of
dfs_tpu's ``ops/ec.py``.

A stripe of ``k`` data shards gains two parity shards

    P = d_0 ^ d_1 ^ ... ^ d_{k-1}
    Q = g^{k-1}·d_0 ^ g^{k-2}·d_1 ^ ... ^ g^0·d_{k-1}        (GF(256))

so any two lost shards of a stripe are recoverable. GF(256) doubling is

    xtime(x) = (x << 1) ^ (0x1D if x & 0x80 else 0)  (mod x^8+x^4+x^3+x^2+1)

and Q is the Horner scan ``q = xtime(q) ^ d_i``: bitwise work with no
tables. The NumPy forms (``encode_pq_np``, ``recover_stripe``) are copies
of dfs_tpu's and are the byte-exact oracles.

The device forms are plain PyTorch (dfs_tpu ran them as XLA, not Pallas),
on ``uint8`` tensors: GF(256) acts on each byte alone, so bytes need no
packing, move exactly the bytes of the shards, and never leave 8 bits in
``xtime`` (a signed 32-bit word would sign-extend under ``>>`` and corrupt
Q; the CPU build has no ``uint32`` shift). One body serves NumPy (``u32``
words, as dfs_tpu) and torch (bytes): :func:`_gf_mul_const`,
:func:`_solve_group` and the reductions take the array module.

Device entry points follow :func:`dfs_tpu_torch.resolve_device`: ``cuda``
unless the caller passes ``device="cpu"``, and raising without CUDA.
:func:`encode_stripes` is the form the node runs: every stripe of a file
in one host-to-device copy, one pass per group of equal width and padded
length, one copy back.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dfs_tpu_torch import resolve_device

_POLY = 0x1D  # x^8 + x^4 + x^3 + x^2 + 1: 2 generates GF(256)* here


# ---------------------------------------------------------------------------
# GF(256) tables (decode-time only)
# ---------------------------------------------------------------------------

@functools.cache
def _tables() -> tuple[np.ndarray, np.ndarray]:
    """(log, exp) tables for generator 2: exp[i] = 2^i, log[exp[i]] = i."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY | 0x100
    exp[255:510] = exp[:255]
    return log, exp


def gf_mul(a: int, b: int) -> int:
    """Scalar GF(256) multiply (decode coefficients only)."""
    if a == 0 or b == 0:
        return 0
    log, exp = _tables()
    return int(exp[int(log[a]) + int(log[b])])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) inverse of 0")
    log, exp = _tables()
    return int(exp[255 - int(log[a])])


def gf_pow(a: int, n: int) -> int:
    r = 1
    for _ in range(n):
        r = gf_mul(r, a)
    return r


def _gf_mul_bytes(c: int, x: np.ndarray) -> np.ndarray:
    """Constant × byte-array multiply via log/exp (decode path)."""
    if c == 0:
        return np.zeros_like(x)
    log, exp = _tables()
    out = np.zeros_like(x)
    nz = x != 0
    out[nz] = exp[int(log[c]) + log[x[nz].astype(np.int32)]]
    return out


# ---------------------------------------------------------------------------
# encode: the NumPy oracle over u32 words, the torch form over bytes
# ---------------------------------------------------------------------------

def _xtime_np(x: np.ndarray) -> np.ndarray:
    """GF doubling on u32 words holding 4 independent byte lanes, with
    explicit ``out=`` so a pass allocates two temporaries."""
    x = x.astype(np.uint32, copy=False)
    hi = np.bitwise_and(x, np.uint32(0x80808080))
    lo = np.bitwise_xor(x, hi)
    np.left_shift(lo, np.uint32(1), out=lo)
    np.right_shift(hi, np.uint32(7), out=hi)
    np.multiply(hi, np.uint32(_POLY), out=hi)
    np.bitwise_xor(lo, hi, out=lo)
    return lo


def encode_pq_np(shards: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """shards [k, L] u8 (equal padded length, L % 4 == 0) ->
    (p [L] u8, q [L] u8). Horner: q = xtime(q) ^ d_i in shard order."""
    k, ln = shards.shape
    if ln % 4:
        raise ValueError("shard length must be a multiple of 4")
    w = shards.view(np.uint32)                     # [k, L/4]
    p = np.zeros_like(w[0])
    q = np.zeros_like(w[0])
    for i in range(k):
        p ^= w[i]
        q = _xtime_np(q) ^ w[i]
    return p.view(np.uint8), q.view(np.uint8)


def xtime(x: torch.Tensor) -> torch.Tensor:
    """GF doubling of a ``uint8`` tensor, byte by byte (the torch twin of
    :func:`_xtime_np`): ``(x ^ hi) << 1`` stays below 0x100 and
    ``(hi >> 7) * 0x1D`` is 0 or 0x1D."""
    if x.dtype != torch.uint8:
        raise TypeError(f"xtime takes uint8 bytes, got {x.dtype}")
    hi = x & 0x80
    return ((x ^ hi) << 1) ^ ((hi >> 7) * _POLY)


def pq_horner(shards: torch.Tensor, k: int, axis: int = 0):
    """The P/Q recurrence on ``uint8`` tensors: xor-accumulate P and
    Horner Q (``q = xtime(q) ^ d_i``) over the ``k`` shards along
    ``axis``. The one definition of the parity math on the device: the
    single-stripe encode, :func:`encode_stripes` and the sharded mesh step
    (``parallel.sharded_cdc.make_ec_step``) all call it."""
    if shards.shape[axis] != k:
        raise ValueError(
            f"{shards.shape[axis]} shards along axis {axis}, expected {k}")
    p = shards.select(axis, 0)
    q = p                                  # q0 = xtime(0) ^ d0 = d0
    for i in range(1, k):                  # k is small
        d = shards.select(axis, i)
        p = p ^ d
        q = xtime(q) ^ d
    return p, q


def encode_pq(shards: np.ndarray, device=None
              ) -> tuple[np.ndarray, np.ndarray]:
    """P/Q parity of one stripe, ``shards`` [k, L] u8 (L % 4 == 0), on
    ``device`` (None: the card). Byte-identical to :func:`encode_pq_np`."""
    dev = resolve_device(device)
    k, ln = shards.shape
    if ln % 4:
        raise ValueError("shard length must be a multiple of 4")
    p, q = pq_horner(torch.from_numpy(np.ascontiguousarray(shards)).to(dev),
                     k)
    return p.cpu().numpy(), q.cpu().numpy()


def _pad_bucket(ln: int) -> int:
    """The zero-padded length a stripe of padded length ``ln`` is batched
    at: ``ln`` rounded up to 1/8 of its power-of-two ceiling, so the waste
    stays under 25% while stripes of near-unique lengths share a batch.
    Zero padding is GF-exact: the parity of zero-padded shards is the
    zero-padded parity."""
    if not ln:
        return 4
    grain = max(4, 1 << max((ln - 1).bit_length() - 3, 2))
    return -(-ln // grain) * grain


class StripePlan:
    """Where each stripe of a batched encode lies: stripes grouped by
    (width, padded-length bucket), each group a contiguous ``[S, k, B]``
    block of the packed input and an ``[S, 2, B]`` block (P then Q) of the
    output."""

    def __init__(self, stripes) -> None:
        self.shard_len = []
        self.groups: list[tuple[int, int, list[int], int, int]] = []
        keyed: dict[tuple[int, int], list[int]] = {}
        for s, (shards, shard_len) in enumerate(stripes):
            if shard_len % 4:
                raise ValueError(f"stripe {s}: shard length {shard_len} is "
                                 "not a multiple of 4")
            if not shards:
                raise ValueError(f"stripe {s}: no data shards")
            for b in shards:
                if len(b) > shard_len:
                    raise ValueError(f"stripe {s}: a {len(b)}-byte shard "
                                     f"is longer than shard_len {shard_len}")
            self.shard_len.append(shard_len)
            keyed.setdefault((len(shards), _pad_bucket(shard_len)),
                             []).append(s)
        in_off = out_off = 0
        for (k, bucket), idxs in keyed.items():
            self.groups.append((k, bucket, idxs, in_off, out_off))
            in_off += len(idxs) * k * bucket
            out_off += len(idxs) * 2 * bucket
        self.in_bytes, self.out_bytes = in_off, out_off

    def pack(self, stripes) -> np.ndarray:
        """The packed, zero-padded input (host bytes)."""
        host = np.zeros(self.in_bytes, dtype=np.uint8)
        for k, bucket, idxs, in_off, _ in self.groups:
            blk = host[in_off:in_off + len(idxs) * k * bucket].reshape(
                len(idxs), k, bucket)
            for r, s in enumerate(idxs):
                for j, b in enumerate(stripes[s][0]):
                    blk[r, j, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        return host

    def encode(self, packed: torch.Tensor) -> torch.Tensor:
        """P and Q of every stripe from the packed input on its device:
        one :func:`pq_horner` per group."""
        out = torch.empty(self.out_bytes, dtype=torch.uint8,
                          device=packed.device)
        for k, bucket, idxs, in_off, out_off in self.groups:
            n = len(idxs)
            x = packed[in_off:in_off + n * k * bucket].view(n, k, bucket)
            p, q = pq_horner(x, k, axis=1)
            o = out[out_off:out_off + n * 2 * bucket].view(n, 2, bucket)
            o[:, 0] = p
            o[:, 1] = q
        return out

    def unpack(self, out: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
        """Per stripe (p, q) u8, truncated to its shard length."""
        res: list = [None] * len(self.shard_len)
        for _, bucket, idxs, _, out_off in self.groups:
            blk = out[out_off:out_off + len(idxs) * 2 * bucket].reshape(
                len(idxs), 2, bucket)
            for r, s in enumerate(idxs):
                ln = self.shard_len[s]
                res[s] = (blk[r, 0, :ln], blk[r, 1, :ln])
        return res


def encode_stripes(stripes, device=None
                   ) -> list[tuple[np.ndarray, np.ndarray]]:
    """P/Q of many stripes at once — the encode an EC upload runs.
    ``stripes`` is a list of (shards, shard_len): ``shards`` the stripe's
    data shard payloads (bytes-like, each at most ``shard_len`` long, zero
    padded to it), ``shard_len`` a multiple of 4. Returns (p, q) u8 arrays
    of ``shard_len`` bytes per stripe, equal to :func:`encode_pq_np` over
    the zero-padded shards. On ``device`` (None: the card) the work is one
    host-to-device copy of the packed stripes, one :func:`pq_horner` per
    (width, bucket) group, and one synchronous copy back, all on the
    calling thread's current stream; the host buffers are pageable and
    owned by this call."""
    dev = resolve_device(device)
    if not stripes:
        return []
    plan = StripePlan(stripes)
    packed = torch.from_numpy(plan.pack(stripes)).to(dev)
    return plan.unpack(plan.encode(packed).cpu().numpy())


# ---------------------------------------------------------------------------
# decode: recover up to two missing shards
# ---------------------------------------------------------------------------

def _q_coeff(i: int, k: int) -> int:
    """Q's coefficient for data shard i: g^(k-1-i) (Horner order)."""
    return gf_pow(2, k - 1 - i)


def recover_stripe(data: list[np.ndarray | None],
                   p: np.ndarray | None, q: np.ndarray | None
                   ) -> list[np.ndarray]:
    """Recover missing data shards of one stripe. ``data`` is the k-slot
    stripe with ``None`` for lost shards (present arrays all the same
    padded length); ``p``/``q`` are the parity shards or ``None``. Returns
    the complete data list. Raises ValueError when more than two shards
    (counting lost parity) are missing. The per-stripe oracle of
    :func:`recover_stripes`."""
    k = len(data)
    missing = [i for i, d in enumerate(data) if d is None]
    lost = len(missing) + (p is None) + (q is None)
    if lost > 2:
        raise ValueError(f"{lost} shards lost, P+Q recovers at most 2")
    if not missing:
        return [d for d in data]  # type: ignore[misc]
    present = next(d for d in data if d is not None) if k > len(missing) \
        else (p if p is not None else q)
    if present is None:
        raise ValueError("nothing to recover from")
    ln = present.shape[0]
    shapes = {arr.shape[0] for arr in (*data, p, q) if arr is not None}
    if len(shapes) > 1:
        raise ValueError(
            f"present shards have unequal padded lengths {sorted(shapes)}; "
            "pad every shard of a stripe to the stripe's shard_len")
    if ln % 4:
        raise ValueError(
            f"shard length {ln} is not a multiple of 4; the u32-packed "
            "GF lanes require stripe_shard_len padding")

    def xor_known(skip: set[int]) -> np.ndarray:
        acc = np.zeros(ln, dtype=np.uint8)
        w = acc.view(np.uint32)
        for i, d in enumerate(data):
            if i not in skip and d is not None:
                w ^= d.view(np.uint32)
        return acc

    if len(missing) == 1:
        i = missing[0]
        if p is not None:
            # d_i = P ^ xor(other data)
            rec = xor_known({i})
            rec.view(np.uint32)[:] ^= p.view(np.uint32)
            out = list(data)
            out[i] = rec
            return out  # type: ignore[return-value]
        # P lost too -> solve from Q: g^(k-1-i)·d_i = Q ^ sum g^..·d_j
        acc = np.zeros(ln, dtype=np.uint8)
        for j, d in enumerate(data):
            if j != i and d is not None:
                acc ^= _gf_mul_bytes(_q_coeff(j, k), d)
        acc ^= q
        out = list(data)
        out[i] = _gf_mul_bytes(gf_inv(_q_coeff(i, k)), acc)
        return out  # type: ignore[return-value]

    # two data shards missing: need both P and Q
    if p is None or q is None:
        raise ValueError("two data shards and a parity shard lost")
    a, b = missing
    ca, cb = _q_coeff(a, k), _q_coeff(b, k)
    # P ^ known = d_a ^ d_b           = s
    # Q ^ known = ca·d_a ^ cb·d_b    = t
    s = xor_known({a, b})
    s.view(np.uint32)[:] ^= p.view(np.uint32)
    t = np.zeros(ln, dtype=np.uint8)
    for j, d in enumerate(data):
        if j not in (a, b) and d is not None:
            t ^= _gf_mul_bytes(_q_coeff(j, k), d)
    t ^= q
    # d_a = (cb·s ^ t) / (ca ^ cb)
    denom_inv = gf_inv(ca ^ cb)
    da = _gf_mul_bytes(denom_inv, _gf_mul_bytes(cb, s) ^ t)
    db = s ^ da
    out = list(data)
    out[a] = da
    out[b] = db
    return out  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# batched decode: every affected stripe of a read in one vectorized solve
# ---------------------------------------------------------------------------

def _xtime_for(xp):
    return _xtime_np if xp is np else xtime


def _gf_mul_const(c: int, x, xp=np):
    """GF(256) multiply of an array by a constant: c = XOR of 2^b over
    its set bits and x·2^b is b applications of xtime, so x·c = XOR over
    set bits of xtime^b(x). The decode groups stripes by their missing
    pattern so these scalars are constants. One body for NumPy and
    torch."""
    if not 0 <= c <= 0xFF:
        raise ValueError(f"GF(256) scalar out of range: {c}")
    if c == 0:
        return xp.zeros_like(x)
    xt = _xtime_for(xp)
    acc = None
    cur = x
    b = 0
    while True:
        if c >> b & 1:
            acc = cur if acc is None else acc ^ cur
        b += 1
        if not c >> b:
            return acc
        cur = xt(cur)


def _solve_group(xp, case_id: int, D, P, Q, ea_inv: int, cb: int,
                 denom_inv: int, k: int):
    """Vectorized P+Q solve over one stripe group homogeneous in (k,
    padded length, erasure case, missing-index pattern).

    D [S, k, W] — data shards, missing slots zeroed; P/Q [S, W];
    case_id — 0: single loss with P present (d = X = P ^ xor(data)),
    1: single loss solved from Q (d = inv(c)·T, T = Q ^ Horner(data)),
    2: double loss (d_a = inv(ca^cb)·(cb·X ^ T), d_b = X ^ d_a);
    ea_inv/cb/denom_inv — the group's constant coefficients.
    Returns (ra, rb); rb only for case 2. NumPy works on u32 words, torch
    on bytes; the code is the same."""
    if case_id == 0:
        return P ^ _xor_reduce(xp, D), None
    if case_id == 1:
        T = Q ^ _horner_reduce(xp, D, k)
        return _gf_mul_const(ea_inv, T, xp), None
    X = P ^ _xor_reduce(xp, D)
    T = Q ^ _horner_reduce(xp, D, k)
    ra = _gf_mul_const(denom_inv, _gf_mul_const(cb, X, xp) ^ T, xp)
    return ra, X ^ ra


def _xor_reduce(xp, D):
    acc = D[:, 0]
    for i in range(1, D.shape[1]):
        acc = acc ^ D[:, i]
    return acc


def _horner_reduce(xp, D, k: int):
    xt = _xtime_for(xp)
    q = D[:, 0]
    for i in range(1, k):
        q = xt(q) ^ D[:, i]
    return q


def _solve_on(dev: torch.device):
    """The group solve in torch on ``dev``: the u32 host stacks go over as
    bytes and come back as u32 words."""
    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.view(np.uint8)).to(dev)

    def back(t):
        return None if t is None else np.ascontiguousarray(
            t.cpu().numpy()).view(np.uint32)

    def solve(case, D, P, Q, ea_inv, cb, denom_inv, k):
        ra, rb = _solve_group(torch, case, put(D), put(P), put(Q), ea_inv,
                              cb, denom_inv, k)
        return back(ra), back(rb)

    return solve


def _recover(stripes, solve) -> list[list[np.ndarray]]:
    """Validation, grouping and scatter of :func:`recover_stripes`;
    ``solve`` runs one group."""
    if not stripes:
        return []

    results: list[list[np.ndarray] | None] = [None] * len(stripes)
    groups: dict[tuple[int, int, int, int, int], list[int]] = {}
    true_len: dict[int, int] = {}
    for s, (data, p, q) in enumerate(stripes):
        k = len(data)
        missing = [i for i, d in enumerate(data) if d is None]
        lost = len(missing) + (p is None) + (q is None)
        if lost > 2:
            raise ValueError(
                f"stripe {s}: {lost} shards lost, P+Q recovers at most 2")
        if not missing:
            results[s] = list(data)  # type: ignore[arg-type]
            continue
        if len(missing) == 2 and (p is None or q is None):
            raise ValueError(
                f"stripe {s}: two data shards and a parity shard lost")
        if len(missing) == 1 and p is None and q is None:
            raise ValueError(f"stripe {s}: data shard and both parities "
                             "lost")
        present = [a for a in (*data, p, q) if a is not None]
        lens = {a.shape[0] for a in present}
        if len(lens) != 1:
            raise ValueError(
                f"stripe {s}: present shards have unequal padded lengths "
                f"{sorted(lens)}")
        ln = lens.pop()
        if ln % 4:
            raise ValueError(
                f"stripe {s}: shard length {ln} is not a multiple of 4")
        true_len[s] = ln
        a = missing[0]
        b = missing[1] if len(missing) == 2 else -1
        if b >= 0:
            case = 2
        elif p is None:
            case = 1
        else:
            case = 0
        groups.setdefault((k, _pad_bucket(ln), case, a, b), []).append(s)

    for (k, bucket, case, a, b), idxs in groups.items():
        S = len(idxs)
        W = bucket // 4
        D = np.zeros((S, k, W), dtype=np.uint32)
        P = np.zeros((S, W), dtype=np.uint32)
        Q = np.zeros((S, W), dtype=np.uint32)
        for r, s in enumerate(idxs):
            data, p, q = stripes[s]
            wn = true_len[s] // 4
            for i, d in enumerate(data):
                if d is not None:
                    D[r, i, :wn] = d.view(np.uint32)
            if case != 1 and p is not None:
                P[r, :wn] = p.view(np.uint32)
            if case != 0 and q is not None:
                Q[r, :wn] = q.view(np.uint32)
        ca = _q_coeff(a, k)
        cb = _q_coeff(b, k) if b >= 0 else 0
        ea_inv = gf_inv(ca)
        denom_inv = gf_inv(ca ^ cb) if b >= 0 else 0
        ra, rb = solve(case, D, P, Q, ea_inv, cb, denom_inv, k)

        for r, s in enumerate(idxs):
            data, p, q = stripes[s]
            ln = true_len[s]
            out = list(data)
            out[a] = np.ascontiguousarray(ra[r]).view(np.uint8)[:ln]
            if b >= 0:
                out[b] = np.ascontiguousarray(rb[r]).view(np.uint8)[:ln]
            results[s] = out  # type: ignore[assignment]
    return results  # type: ignore[return-value]


def recover_stripes_np(stripes: list[tuple[list[np.ndarray | None],
                                           np.ndarray | None,
                                           np.ndarray | None]]
                       ) -> list[list[np.ndarray]]:
    """Batched :func:`recover_stripe` on the host: one vectorized GF(256)
    solve per group of stripes instead of a per-stripe loop. ``stripes``
    is a list of (data, p, q) as recover_stripe takes them, each within
    the two-erasure budget. Stripes are grouped by (width, padded-length
    bucket, erasure case, missing pattern) and zero-padded to the bucket
    (:func:`_pad_bucket`); the scatter truncates back. The degraded-read
    engine of the node (as in dfs_tpu, whose production decode is its
    NumPy path)."""
    return _recover(stripes, functools.partial(_solve_group, np))


def recover_stripes(stripes: list[tuple[list[np.ndarray | None],
                                        np.ndarray | None,
                                        np.ndarray | None]],
                    device=None) -> list[list[np.ndarray]]:
    """:func:`recover_stripes_np` with each group solved in torch on
    ``device`` (None: the card); the same grouping, the same code."""
    return _recover(stripes, _solve_on(resolve_device(device)))
