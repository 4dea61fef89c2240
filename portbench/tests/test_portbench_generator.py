"""``backup-incr`` makes the same bodies from the same numbers, and
different ones from different numbers."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import generator, registry

MIX = dict(registry.load_mix("backup-incr"), file_bytes=256 * 1024)
SEED = 2**31 + 12345          # larger than 32 signed bits hold


def _body(seed, a, stream, g):
    return generator.body(MIX, seed, a, stream, g,
                          generator.base_file(MIX, seed, a))


@pytest.mark.parametrize("stream", ["warm", "window"])
def test_the_same_numbers_make_the_same_body(stream):
    a = _body(SEED, 3, stream, 7)
    b = _body(SEED, 3, stream, 7)
    assert np.array_equal(a, b)
    assert a.shape[0] == MIX["file_bytes"] + 1024      # the insertion


@pytest.mark.parametrize("other", [(SEED + 1, 3, "window", 7),
                                   (SEED, 4, "window", 7),
                                   (SEED, 3, "window", 8),
                                   (SEED, 3, "warm", 7)])
def test_different_numbers_make_a_different_body(other):
    assert not np.array_equal(_body(SEED, 3, "window", 7), _body(*other))


def test_a_mix_without_a_base_makes_fresh_files():
    mix = dict(MIX, base="fresh")
    assert generator.base_file(mix, SEED, 0) is None
    a = generator.body(mix, SEED, 0, "window", 1, None)
    assert a.shape[0] == mix["file_bytes"]
    assert np.array_equal(a, generator.body(mix, SEED, 0, "window", 1, None))


def _naive(mix, seed, a, stream, g):
    """The edits applied to a whole copy, the way they read in the mix."""
    rng = generator._rng(seed, a, generator.STREAMS[stream], g)
    out = generator.base_file(mix, seed, a).copy()
    for e in mix["edits"]:
        n = int(e["bytes"])
        if e["kind"] == "overwrite":
            at = int(rng.integers(0, out.shape[0] - n + 1))
            out[at:at + n] = np.frombuffer(rng.bytes(n), np.uint8)
        else:
            at = int(rng.integers(0, out.shape[0] + 1))
            out = np.concatenate([out[:at], np.frombuffer(rng.bytes(n),
                                                          np.uint8),
                                  out[at:]])
    return out


@pytest.mark.parametrize("g", range(6))
def test_pieces_are_the_edits_applied_to_a_copy(g):
    assert np.array_equal(_body(SEED, 2, "window", g),
                          _naive(MIX, SEED, 2, "window", g))


@pytest.mark.parametrize("at,cut", [(0, 0), (0, 5), (3, 0), (3, 4), (9, 3),
                                    (12, 0), (5, 7)])
def test_splice_replaces_the_bytes_it_names(at, cut):
    parts = [np.arange(0, 5, dtype=np.uint8), np.arange(5, 12,
                                                        dtype=np.uint8)]
    whole = np.arange(12, dtype=np.uint8)
    new = b"\xf0\xf1"
    want = np.concatenate([whole[:at], np.frombuffer(new, np.uint8),
                           whole[at + cut:]])
    got = generator._splice(parts, at, cut, new)
    assert np.array_equal(np.concatenate(got), want)
    assert all(len(p) for p in got)


def test_blocks_cut_the_body_into_whole_blocks():
    parts = generator.pieces(MIX, SEED, 1, "window", 3,
                             generator.base_file(MIX, SEED, 1))
    block = 1000
    out = list(generator.blocks(parts, block))
    assert all(len(b) == block for b in out[:-1])
    assert 0 < len(out[-1]) <= block
    assert b"".join(bytes(b) for b in out) == np.concatenate(parts).tobytes()


def test_every_seed_stores_the_same_corpus_dealt_otherwise():
    def dealt(seed):
        return [generator.base_file(MIX, seed, a).tobytes()
                for a in range(MIX["agents"])]

    first = dealt(SEED)
    assert len(set(first)) == MIX["agents"]
    orders = {tuple(generator.corpus_index(MIX, s, a)
                    for a in range(MIX["agents"])) for s in range(SEED,
                                                                  SEED + 8)}
    assert len(orders) > 1
    for s in (SEED + 1, 7, 2**31 - 1):
        assert sorted(dealt(s)) == sorted(first)
