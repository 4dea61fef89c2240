"""SHA-256 in plain PyTorch, vectorised over lanes; kernel 6, the batched
SHA-256 of pre-padded messages (dfs_tpu's ``ops/sha256_jax.py``); and
kernel 7, the SHA-256 of byte spans of one resident array (dfs_tpu's
``ops/pack_jax.py`` ``digest_gathered``).

Values are u32 carried in int64 (see ``utils.u32``). A rotation uses the
doubled word ``x | x << 32``: its right shift by ``n`` holds ``rotr(x, n)``
in the low 32 bits whatever happens above them, so each sum masks once at
the end instead of after every rotation.

Layouts shared with the kernels (S = lanes, bps = blocks per lane):
  words_t  [bps*16, S] u32   block t's BE word w of lane s at [t*16+w, s]
  cutflag  [bps, S]    i32   1 after the last block of a chunk
  states   [bps*8, S]  u32   post-block state word i at [t*8+i, s]
"""

from __future__ import annotations

import numpy as np
import torch

from dfs_tpu_torch import kernels, resolve_device
from dfs_tpu_torch.utils import u32

M = u32.M32

_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)

_H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)

_KI = [int(k) for k in _K]
_HI = [int(h) for h in _H0]


def h0_tensor(device) -> torch.Tensor:
    """H0 as an int64 [8] tensor."""
    return torch.tensor(_HI, dtype=torch.int64, device=device)


def _dbl(x: torch.Tensor) -> torch.Tensor:
    return x | (x << 32)


def schedule(w16: list[torch.Tensor]) -> list[torch.Tensor]:
    """Message schedule: 16 words -> 64 words, each plus its round
    constant K[t] (unmasked; < 2**33), ready for :func:`rounds`."""
    w = list(w16)
    for t in range(16, 64):
        x, y = w[t - 15], w[t - 2]
        xd, yd = _dbl(x), _dbl(y)
        s0 = ((xd >> 7) ^ (xd >> 18) ^ (x >> 3)) & M
        s1 = ((yd >> 17) ^ (yd >> 19) ^ (y >> 10)) & M
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M)
    return [wt + k for wt, k in zip(w, _KI)]


def rounds(state8: list[torch.Tensor], wk: list[torch.Tensor]
           ) -> list[torch.Tensor]:
    """The 64 compression rounds plus the feed-forward. wk: 64 words from
    :func:`schedule` (W[t] + K[t])."""
    a, b, c, d, e, f, g, h = state8
    for t in range(64):
        ed = _dbl(e)
        s1 = ((ed >> 6) ^ (ed >> 11) ^ (ed >> 25)) & M
        ch = g ^ (e & (f ^ g))
        t1 = h + s1 + ch + wk[t]
        ad = _dbl(a)
        s0 = ((ad >> 2) ^ (ad >> 13) ^ (ad >> 22)) & M
        maj = (a & b) | (c & (a | b))
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & M, c, b, a,
                                  (t1 + s0 + maj) & M)
    return [(s + v) & M for s, v in zip(state8, [a, b, c, d, e, f, g, h])]


def compress(state8: list[torch.Tensor], w16: list[torch.Tensor]
             ) -> list[torch.Tensor]:
    """One SHA-256 compression; state8/w16: lists of identically-shaped
    int64 u32 tensors (elementwise over any shape)."""
    return rounds(state8, schedule(w16))


def strip_states(words_t: torch.Tensor, cutflag: torch.Tensor
                 ) -> torch.Tensor:
    """The strip scan: (words_t [bps*16, S] u32 BE, cutflag [bps, S]) ->
    states [bps*8, S] u32 — each lane chains its blocks in order, emits the
    post-block state, and resets to H0 after a flagged block."""
    rows, s = words_t.shape
    bps = rows // 16
    dev = words_t.device
    w = u32.widen(words_t).reshape(bps, 16, s)
    # the schedule does not depend on the chain: all blocks at once
    wk = torch.stack(schedule([w[:, i, :] for i in range(16)]), dim=1)
    h0 = h0_tensor(dev)[:, None].expand(8, s)
    cut = cutflag.reshape(bps, s) != 0
    state = [h0[i] for i in range(8)]
    out = torch.empty((bps, 8, s), dtype=torch.int64, device=dev)
    for t in range(bps):
        new = rounds(state, [wk[t, i] for i in range(64)])
        out[t] = torch.stack(new)
        state = [torch.where(cut[t], h0[i], new[i]) for i in range(8)]
    return u32.narrow(out.reshape(bps * 8, s))


def pad_block(lens: torch.Tensor) -> list[torch.Tensor]:
    """The 16 words of the synthetic FIPS padding block that follows a
    chunk of ``lens`` bytes (a multiple of 64): 0x80, zeros, bit length."""
    ln = lens.to(torch.int64) & M
    zero = torch.zeros_like(ln)
    return ([torch.full_like(ln, 0x80000000)] + [zero] * 13
            + [ln >> 29, (ln * 8) & M])


def cut_state_rows(states: torch.Tensor, s: int) -> torch.Tensor:
    """Relayout [bps*8, S] states to row-contiguous [bps*S, 8] so a chunk's
    state is one 32-byte row."""
    rows = states.shape[0]
    bps = rows // 8
    v = states.view(torch.int32) if states.dtype == torch.uint32 else states
    out = v.reshape(bps, 8, s).transpose(1, 2).reshape(bps * s, 8)
    return out.view(torch.uint32) if states.dtype == torch.uint32 else out


# ---------------------------------------------------------------------------
# kernel 6: batched SHA-256 of pre-padded messages
# ---------------------------------------------------------------------------
# Counterpart of dfs_tpu/ops/sha256_jax.py, whose _sha256_blocks_impl is XLA
# (a masked lax.scan over the blocks), not Pallas. CUDA design
# (csrc/sha256_blocks.cu on csrc/sha256_chain.cuh): one thread of a
# consumer warp a message runs the rounds alone, a producer warp on another
# scheduler loads the next block and computes its schedule; the longest
# message's chain of compressions bounds it. The plain version steps the
# blocks in Python, thousands of small launches per block step on a card.

NAME_K6 = "sha256_blocks"


def sha256_blocks_plain(words: torch.Tensor, nblocks: torch.Tensor
                        ) -> torch.Tensor:
    """(words [B, L, 16] u32 BE, nblocks [B] i32) -> [B, 8] u32: each row
    advances through its blocks while ``l < nblocks`` and keeps its state
    after that (``nblocks <= 0``: H0), as dfs_tpu's masked scan does."""
    bsz, nblk, _ = words.shape
    w = u32.widen(words)
    nb = nblocks.to(torch.int64)
    h0 = h0_tensor(words.device)
    state = [h0[i].expand(bsz) for i in range(8)]
    # the scan past the longest row leaves every state unchanged
    steps = min(nblk, int(nb.max())) if bsz else 0
    for blk in range(steps):
        new = compress(state, [w[:, blk, i] for i in range(16)])
        keep = blk < nb
        state = [torch.where(keep, n, s) for n, s in zip(new, state)]
    return u32.narrow(torch.stack(state, dim=1)) if bsz else \
        torch.zeros((0, 8), dtype=torch.uint32, device=words.device)


def sha256_blocks(words: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Kernel 6. CPU tensors take the plain version; CUDA tensors launch
    the kernel (or raise)."""
    if words.device.type == "cpu":
        return sha256_blocks_plain(words, nblocks)
    kernels.check_cuda(NAME_K6, words, torch.uint32, 3)
    kernels.check_cuda(NAME_K6, nblocks, torch.int32, 1)
    bsz, nblk, width = words.shape
    if width != 16 or nblocks.shape[0] != bsz \
            or nblocks.device != words.device:
        raise ValueError(f"{NAME_K6}: bad shapes {tuple(words.shape)}, "
                         f"{tuple(nblocks.shape)}")
    out = torch.empty((bsz, 8), dtype=torch.uint32, device=words.device)
    kernels.launch(NAME_K6, words.device, words.data_ptr(),
                   nblocks.data_ptr(), out.data_ptr(), bsz, nblk)
    return out


# ---------------------------------------------------------------------------
# kernel 7: SHA-256 of byte spans of one resident array
# ---------------------------------------------------------------------------
# Counterpart of dfs_tpu/ops/pack_jax.py digest_gathered (XLA: a gather, the
# FIPS padding and the packing per power-of-two length bucket, then the
# batched scan). CUDA design (csrc/sha256_spans.cu on csrc/sha256_chain.cuh):
# the gather, the padding and the packing inside the kernel, one launch for
# every span, the spans taken longest first; the longest span's chain of
# compressions bounds it. The plain version: ops.pack.pack_gathered, then
# sha256_blocks_plain.

NAME_K7 = "sha256_spans"


def _host_i64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=np.int64).reshape(-1)


def span_table(starts, lens, m: int) -> np.ndarray:
    """[3, N] i32: the starts, the lengths and the longest-first order
    (stable) of N spans of an ``m``-byte array. Raises on a negative
    length, a span outside the array, or a start or length past int32:
    exactly the spans kernel 7 takes."""
    st, ln = _host_i64(starts), _host_i64(lens)
    if st.shape != ln.shape:
        raise ValueError(f"{NAME_K7}: {st.shape[0]} starts, "
                         f"{ln.shape[0]} lengths")
    if ln.size and int(ln.min()) < 0:
        raise ValueError(f"{NAME_K7}: negative span length {int(ln.min())}")
    if st.size and (int(st.min()) < 0 or int((st + ln).max()) > m):
        raise ValueError(f"{NAME_K7}: a span lies outside the {m}-byte "
                         "array")
    if st.size and max(int(st.max()), int(ln.max())) >= 2**31:
        raise ValueError(f"{NAME_K7}: span starts and lengths must fit in "
                         "int32")
    order = np.argsort(-ln, kind="stable")
    return np.stack([st, ln, order]).astype(np.int32)


def sha256_spans_plain(data: torch.Tensor, starts, lens) -> torch.Tensor:
    """(data [M] u8, starts [N], lens [N] >= 0) -> [N, 8] u32: the SHA-256
    state of each span ``data[start:start + len]`` after its FIPS padding,
    as dfs_tpu's ``digest_gathered`` computes it for rows with ``lens >=
    0``."""
    from dfs_tpu_torch.ops.pack import pack_gathered

    table = span_table(starts, lens, data.shape[0])
    n = table.shape[1]
    if n == 0:
        return torch.zeros((0, 8), dtype=torch.uint32, device=data.device)
    src = data if data.numel() else data.new_zeros(1)
    st, ln = (torch.from_numpy(table[i]).to(data.device) for i in (0, 1))
    l64 = (int(table[1].max()) + 8) // 64 * 64 + 64
    return sha256_blocks_plain(*pack_gathered(src, st, ln, l64))


def sha256_spans(data: torch.Tensor, starts, lens) -> torch.Tensor:
    """Kernel 7. ``starts``/``lens``: host arrays (or tensors, brought to
    the host: the wrapper orders the spans longest first there). A CPU
    ``data`` takes the plain version; a CUDA one launches the kernel, one
    launch for every span (or raises)."""
    if data.device.type == "cpu":
        return sha256_spans_plain(data, starts, lens)
    kernels.check_cuda(NAME_K7, data, torch.uint8, 1)
    table = span_table(starts, lens, data.shape[0])
    n = table.shape[1]
    out = torch.empty((n, 8), dtype=torch.uint32, device=data.device)
    if n:
        spans = torch.from_numpy(table).to(data.device)
        kernels.launch(NAME_K7, data.device, data.data_ptr(), data.numel(),
                       spans.data_ptr(), out.data_ptr(), n)
    return out


def pad_messages(chunks: list, n_blocks: int | None = None,
                 batch: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """FIPS 180-4 padding on the host -> (words [rows, nblk, 16] u32 BE,
    nblocks [rows] i32). The block axis is rounded up to ``n_blocks`` and
    the rows to ``batch``; extra rows get nblocks 0 and hash to H0."""
    bsz = len(chunks)
    max_len = max((len(c) for c in chunks), default=0)
    nblk = max(n_blocks or 0, (max_len + 8) // 64 + 1)
    rows = max(batch or 0, bsz)
    buf = np.zeros((rows, nblk * 64), dtype=np.uint8)
    counts = np.zeros((rows,), dtype=np.int32)
    for i, c in enumerate(chunks):
        a = c if isinstance(c, np.ndarray) else np.frombuffer(c, np.uint8)
        n = a.shape[0]
        buf[i, :n] = a
        buf[i, n] = 0x80
        nb = (n + 8) // 64 + 1
        buf[i, nb * 64 - 8:nb * 64] = np.frombuffer(
            (n * 8).to_bytes(8, "big"), dtype=np.uint8)
        counts[i] = nb
    words = np.ascontiguousarray(buf).view(">u4").astype(np.uint32)
    return words.reshape(rows, nblk, 16), counts


def state_to_hex(state) -> list[str]:
    """[B, 8] u32 (array or tensor) -> lowercase hex digests."""
    if isinstance(state, torch.Tensor):
        state = state.cpu().view(torch.int32).numpy().view(np.uint32)
    be = np.ascontiguousarray(np.asarray(state, dtype=np.uint32)
                              .astype(">u4"))
    hx = be.tobytes().hex()
    return [hx[i * 64:(i + 1) * 64] for i in range(be.shape[0])]


def u32_tensor(words: np.ndarray, device) -> torch.Tensor:
    """A host u32 array as a uint32 tensor on ``device`` (a read-only
    array, such as a view of ``bytes``, is copied first)."""
    a = np.ascontiguousarray(words)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a.view(np.int32)).to(device).view(torch.uint32)


def sha256_batch_hex(chunks: list, device=None) -> list[str]:
    """Digest a batch of messages with kernel 6 on ``device`` (None: the
    card; "cpu": the plain version); rows and blocks rounded up to powers
    of two, as dfs_tpu rounds its compile shapes."""
    if not chunks:
        return []
    dev = resolve_device(device)
    n = len(chunks)
    need = max(len(c) for c in chunks)

    def pow2(x: int) -> int:
        return 1 << (max(1, x) - 1).bit_length()

    words, counts = pad_messages(chunks, n_blocks=pow2((need + 8) // 64 + 1),
                                 batch=pow2(n))
    state = sha256_blocks(u32_tensor(words, dev),
                          torch.from_numpy(counts).to(dev))
    return state_to_hex(state)[:n]
