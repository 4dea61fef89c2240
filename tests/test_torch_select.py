"""Kernel 4's formulation, without a card and without JAX.

The CUDA walk (``dfs_tpu_torch/csrc/select_walk.cu``) takes each step from
one record instead of the 65-tile window: ``pred(x)``, the largest kept
anchor ``<= x = hi - 1``, from the tile's two entries and ``q``, the max
anchor of the tiles before it (at least the window's width of them).
:func:`select_walk_model` is that algorithm in NumPy, with the kernel's
ring of record chunks: it checks that every record a step reads lies in a
chunk the walk has entered and that no refill has overwritten. Here it is
held against the port's plain version on every case of
:func:`select_cases` and :func:`large_segment_cases`;
``tests/test_torch_kernels.py`` holds both against the JAX scan on the
first and ``tests/test_torch_cuda.py`` the kernel on the card on both. The
cases are the two select tests' random ones plus the adversarial
geometries: no anchors, anchors exactly at ``lo - 1`` and ``hi - 1``, a
window whose only in-range entry is on plane 1, windows past the table,
``n <= seg_max``, ``start0 != 0``, a table of more than two of the
kernel's 4096-tile chunks, and the ``seg_max`` of large chunk sizes
(512 KiB and 4 MiB: fewer steps between the kernel's chunk checks, and
steps longer than a chunk).
"""

import numpy as np
import pytest
import torch

from dfs_tpu_torch.ops.select import (NO_ANCHOR, TILE_BYTES, TILE_SHIFT,
                                      select_walk_plain)

# (seg_min, seg_max) of tests/test_cdc_anchored.py's SMALL params, of the
# default AnchoredCdcParams, and of the params a node derives for a
# --max-chunk of 512 KiB, 4 MiB, 8 MiB (restic's and Borg's) and 32 MiB
# (the largest lane dfs_tpu's default 64 MiB region allows): strips of
# 8192 to 524,288 blocks, seg_max one strip, seg_min three quarters of it
SEGMENTS = {"small": (2048, 4096), "prod": (96 * 1024, 128 * 1024),
            "512k": (384 * 1024, 512 * 1024),
            "4m": (3 * 2**20, 4 * 2**20),
            "8m": (6 * 2**20, 8 * 2**20),
            "32m": (24 * 2**20, 32 * 2**20)}
RECORD_CHUNK = 4096     # tiles a chunk of the kernel's record ring


def random_two_plane_tiles(rng, m_tiles, density=2):
    """Random anchor-tile planes with make_anchor_fn's invariants (the
    generator tests/test_cdc_anchored.py uses)."""
    tiles = np.full((2, m_tiles), NO_ANCHOR, np.int32)
    k = max(1, m_tiles // density)
    idx = rng.choice(m_tiles, size=k, replace=False)
    off1 = rng.integers(0, TILE_BYTES - 1, size=k)
    tiles[0, idx] = (idx * TILE_BYTES + off1).astype(np.int32)
    has2 = rng.random(k) < 0.5
    off2 = off1 + 1 + rng.integers(0, TILE_BYTES - 1 - off1)
    tiles[1, idx[has2]] = (idx[has2] * TILE_BYTES
                           + off2[has2]).astype(np.int32)
    return tiles


def tiles_from_positions(pos, m_tiles):
    """The first two of the sorted anchor positions in each tile, the rule
    anchor_tiles applies; positions past the table are dropped."""
    tiles = np.full((2, m_tiles), NO_ANCHOR, np.int32)
    for p in sorted(set(int(x) for x in pos)):
        t = p // TILE_BYTES
        if t >= m_tiles:
            continue
        if tiles[0, t] == NO_ANCHOR:
            tiles[0, t] = p
        elif tiles[1, t] == NO_ANCHOR:
            tiles[1, t] = p
    return tiles


def edge_positions(seg_min, seg_max, start0, n):
    """Anchors that put a walk from ``start0`` on every edge of the window,
    each edge step followed by a forced one (no anchor in its window) so
    that no anchor reaches a neighbouring window: an anchor at ``lo - 1``
    alone, at ``hi - 1`` alone, at ``lo - 1`` and ``hi - 1``, just outside
    on both sides (``lo - 2`` and ``hi``), an odd offset inside (so that
    later windows start mid-tile), three in one tile (the third is not
    kept), and a tile whose first entry lies below ``lo - 1`` and whose
    second is the only one in range."""
    pos = []
    s = start0
    kinds = ["odd", "lo", "hi", "both", "outside", "three", "plane1"]
    k = 0
    while s + 3 * seg_max < n:
        lo1, hi1 = s + seg_min - 1, s + seg_max - 1
        kind = kinds[k % len(kinds)]
        if kind == "odd":
            pos.append(lo1 + 37)
            b = lo1 + 38
        elif kind == "lo":
            pos.append(lo1)
            b = lo1 + 1
        elif kind == "hi":
            pos.append(hi1)
            b = hi1 + 1
        elif kind == "both":
            pos += [lo1, hi1]
            b = hi1 + 1
        elif kind == "outside":
            pos += [lo1 - 1, hi1 + 1]
            b = s + seg_max
        elif kind == "three":
            base = (lo1 // TILE_BYTES + 2) * TILE_BYTES
            pos += [base + 3, base + 9, base + 30]
            b = base + 10
        else:
            off = lo1 % TILE_BYTES
            if off:      # same tile: one entry below lo - 1, one in range
                pos += [lo1 - 1, lo1 + min(5, TILE_BYTES - 1 - off)]
                b = lo1 + min(5, TILE_BYTES - 1 - off) + 1
            else:
                pos.append(lo1 + 5)
                b = lo1 + 6
        k += 1
        s = b + seg_max          # the forced step after it
    return pos


def select_cases():
    """[(label, kind, tiles [2, m_tiles] i32, n, start0, final)]: the
    random cases of tests/test_cdc_anchored.py's two select tests (SMALL
    params on random regions with start0 in {0, 1234}; the production
    geometry on a 4 MiB region), then the adversarial ones."""
    rng = np.random.default_rng(11)
    cases = []
    for r in range(2):
        n = int(rng.integers(20000, 120000))
        m_tiles = 1 << (-(-n // TILE_BYTES) - 1).bit_length()
        tiles = random_two_plane_tiles(rng, m_tiles)
        for final in (True, False):
            for start0 in (0, 1234):
                cases.append((f"random{r}-s{start0}-f{int(final)}", "small",
                              tiles, n, start0, final))
    n = 4 * 2**20
    tiles = random_two_plane_tiles(np.random.default_rng(12),
                                   n // TILE_BYTES, density=16)
    for final in (True, False):
        cases.append((f"prod4m-f{int(final)}", "prod", tiles, n, 0, final))

    empty = np.full((2, 128), NO_ANCHOR, np.int32)
    for final in (True, False):
        f = int(final)
        cases.append((f"no-anchors-f{f}", "small", empty, 60001, 0, final))
        cases.append((f"no-anchors-s777-f{f}", "small", empty, 60001, 777,
                      final))
        # the region runs past the table: the last windows read as empty
        past = random_two_plane_tiles(np.random.default_rng(13), 64)
        cases.append((f"past-table-f{f}", "small", past,
                      64 * TILE_BYTES + 700, 0, final))
        cases.append((f"edges-small-f{f}", "small", tiles_from_positions(
            edge_positions(2048, 4096, 0, 128 * TILE_BYTES - 333), 128),
            128 * TILE_BYTES - 333, 0, final))
        cases.append((f"edges-small-s1234-f{f}", "small",
                      tiles_from_positions(edge_positions(
                          2048, 4096, 1234, 120 * TILE_BYTES), 128),
                      120 * TILE_BYTES, 1234, final))
        cases.append((f"edges-prod-f{f}", "prod", tiles_from_positions(
            edge_positions(96 * 1024, 128 * 1024, 0, 4 * 2**20 - 5), 8192),
            4 * 2**20 - 5, 0, final))
        # more than two of the kernel's 4096-tile chunks, dense anchors
        dense = random_two_plane_tiles(np.random.default_rng(14), 9000,
                                       density=1)
        cases.append((f"three-chunks-f{f}", "prod", dense,
                      9000 * TILE_BYTES - 1, 300, final))
    small = random_two_plane_tiles(np.random.default_rng(15), 64)
    for n, start0, final in ((3000, 0, True), (3000, 0, False),
                             (4096, 0, True), (4097, 0, True),
                             (4097, 0, False), (5000, 1000, True),
                             (5000, 1000, False), (20000, 16000, True)):
        cases.append((f"short-n{n}-s{start0}-f{int(final)}", "small", small,
                      n, start0, final))
    return cases


def large_segment_cases():
    """[(label, kind, tiles, n, start0, final)] at the seg_max of large
    chunk sizes, on a 64 MiB table ([2, 131072]): random anchors (mean gap
    8 KiB) and the edge walk, final or not, from 0 and from a carry."""
    n_full, m_full = 64 * 2**20, 131072
    rand = random_two_plane_tiles(np.random.default_rng(16), m_full,
                                  density=16)
    cases = []
    for kind in ("512k", "4m", "8m", "32m"):
        seg_min, seg_max = SEGMENTS[kind]
        edges = tiles_from_positions(edge_positions(
            seg_min, seg_max, 4321, n_full - 77), m_full)
        for final in (True, False):
            f = int(final)
            cases.append((f"{kind}-random-f{f}", kind, rand, n_full, 0,
                          final))
            cases.append((f"{kind}-edges-s4321-f{f}", kind, edges,
                          n_full - 77, 4321, final))
    return cases


CASES = select_cases()
LABELS = [c[0] for c in CASES]
LARGE_CASES = large_segment_cases()
ALL_CASES = CASES + LARGE_CASES


def select_cap(kind, m_tiles):
    return m_tiles * TILE_BYTES // SEGMENTS[kind][0] + 1


def select_walk_model(tiles, start0, n, final, cap, seg_min, seg_max,
                      block=2048, chunk=RECORD_CHUNK, slots=4, max_burst=8):
    """The CUDA kernel's algorithm in NumPy. Records {e0, e1, q}, q the
    largest anchor of the tiles before in the tile's ``block`` (the records
    kernel's CTA: 2048 tiles) and of the ``(seg_max - seg_min) /
    TILE_BYTES`` tiles before that block; then per step one record, at the
    tile of x = min(hi - 1, last byte of the table). The records reach the
    walk through a ring of ``slots`` chunks of ``chunk`` tiles, entered as
    the kernel enters them (a check before each burst of ``min(max_burst,
    chunk bytes / seg_max)`` steps, at least one); a read of a chunk not
    entered, or of a slot refilled since, fails."""
    m_tiles = tiles.shape[1]
    halo = (seg_max - seg_min) >> TILE_SHIFT
    e0, e1 = tiles.astype(np.int64)
    v = np.maximum(np.where(e0 < NO_ANCHOR, e0, -1),
                   np.where(e1 < NO_ANCHOR, e1, -1))
    q = np.full(max(m_tiles, 1), -1, np.int64)
    for base in range(0, m_tiles, block):
        run = np.maximum.accumulate(np.concatenate((
            [v[max(0, base - halo):base].max(initial=-1)],
            v[base:base + block])))
        q[base:base + block] = run[:-1]
    if not m_tiles:
        e0 = e1 = np.full(1, NO_ANCHOR)
    x_max = (m_tiles << TILE_SHIFT) - 1 if m_tiles else 0

    chunk_bytes = chunk << TILE_SHIFT
    n_chunks = max(1, -(-m_tiles // chunk))
    burst = max(1, min(max_burst, chunk_bytes // seg_max))
    reach = (burst - 1) * seg_max
    ring = [None] * slots              # the chunk each slot holds
    for k in range(min(slots, n_chunks)):
        ring[k] = k
    issued = min(slots, n_chunks) - 1
    cur, limit = -1, 0

    def enter_next():
        nonlocal cur, limit, issued
        cur += 1
        limit += chunk_bytes
        assert ring[cur % slots] == cur, "entered a chunk never copied"
        if cur >= 2 and cur - 2 + slots < n_chunks:
            ring[(cur - 2) % slots] = cur - 2 + slots
            issued = cur - 2 + slots

    def record(x):
        t = x >> TILE_SHIFT
        c = t // chunk
        assert c <= cur and ring[c % slots] == c, \
            f"read tile {t} outside the ring"
        return e0[t], e1[t], q[t]

    bounds = np.full(cap, -1, np.int32)
    s, i = start0, 0
    x = min(s + seg_max - 1, x_max)
    done = False
    while not done:
        while min(x + reach, x_max) >= limit:
            enter_next()
        for _ in range(burst):
            r0, r1, rq = record(x)
            fin = n - s <= seg_max
            lo1 = 2**31 - 1 if fin else s + seg_min - 1
            alt = n if fin else s + seg_max
            pred = max(r0 if r0 <= x else rq, r1 if r1 <= x else rq)
            b = pred + 1 if pred >= lo1 else alt
            bounds[i] = -1 if fin and not final else b
            s = b
            x = min(b + seg_max - 1, x_max)
            i += 1
            done = fin or i >= cap
            if done:
                break
    # the kernel waits for every chunk still in flight before it exits
    assert min(n_chunks - 1, max(slots - 1, cur - 2 + slots)) == issued
    return bounds


@pytest.mark.parametrize("label", [c[0] for c in ALL_CASES])
def test_k4_model_matches_plain_version(label):
    """The model against the plain walk, with the kernel's 2048-tile
    record blocks and 4096-tile chunks, and with 8-tile blocks (a halo
    lookback at nearly every step) in chunks of 16 and of 4 tiles (short
    bursts, and steps that enter several chunks)."""
    _, kind, tiles, n, start0, final = \
        ALL_CASES[[c[0] for c in ALL_CASES].index(label)]
    seg_min, seg_max = SEGMENTS[kind]
    cap = select_cap(kind, tiles.shape[1])
    want = select_walk_plain(torch.from_numpy(tiles),
                             torch.tensor([start0, n, int(final)],
                                          dtype=torch.int32),
                             cap, seg_min, seg_max).numpy()
    for block, chunk in ((2048, RECORD_CHUNK), (8, 16), (8, 4)):
        got = select_walk_model(tiles, start0, n, final, cap, seg_min,
                                seg_max, block=block, chunk=chunk)
        np.testing.assert_array_equal(got, want)


def test_edge_cases_reach_every_edge():
    """The edge walks really step on an anchor at lo - 1, on one at
    hi - 1, on a tile whose only in-range entry is on plane 1, and through
    forced steps."""
    seg_min, seg_max = SEGMENTS["small"]
    for start0, n, m_tiles in ((0, 128 * TILE_BYTES - 333, 128),
                               (1234, 120 * TILE_BYTES, 128)):
        tiles = tiles_from_positions(
            edge_positions(seg_min, seg_max, start0, n), m_tiles)
        kept = set(tiles[tiles < NO_ANCHOR].tolist())
        b = select_walk_model(tiles, start0, n, True,
                              select_cap("small", m_tiles), seg_min,
                              seg_max)
        b = b[b >= 0].tolist()
        hits = set()
        for s, bound in zip([start0] + b[:-1], b[:-1]):
            lo1, hi1 = s + seg_min - 1, s + seg_max - 1
            t = lo1 // TILE_BYTES
            if bound == lo1 + 1 and lo1 in kept:
                hits.add("lo")
            if bound == hi1 + 1:
                hits.add("hi" if hi1 in kept else "forced")
            if tiles[0, t] < lo1 <= tiles[1, t] < NO_ANCHOR \
                    and bound == tiles[1, t] + 1:
                hits.add("plane1")
        assert hits == {"lo", "hi", "forced", "plane1"}, hits
