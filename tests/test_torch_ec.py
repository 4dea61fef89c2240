"""The port's P+Q erasure codec (dfs_tpu_torch.ops.ec) and stripe
placement against dfs_tpu's on the same numpy inputs, on the CPU: the
cases of tests/test_ec.py, the torch encode against JAX's device encode
and the NumPy oracle, the batched encode the node runs, the batched
decode on both backends, the sharded EC step against JAX's, and the
placement of every shard. Every comparison is exact, byte for byte."""

import numpy as np
import pytest
import torch

from dfs_tpu.node import placement as ref_placement
from dfs_tpu.ops import ec as R
from dfs_tpu.ring import RingMap as RefRing

from dfs_tpu_torch.node import placement
from dfs_tpu_torch.ops import ec as E
from dfs_tpu_torch.ring import RingMap


def stripe(k: int, ln: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(k, ln), dtype=np.uint8)


def _mul_schoolbook(a: int, b: int) -> int:
    """Carry-less multiply mod x^8+x^4+x^3+x^2+1 (0x11D), bit by bit."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11D
        b >>= 1
    return r


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and np.array_equal(g, w)


# recover_stripes on each backend of the port
RECOVER = {"numpy": E.recover_stripes_np,
           "torch": lambda st: E.recover_stripes(st, device="cpu")}


def test_gf_field_axioms():
    assert E.gf_mul(2, 0x80) == 0x1D
    seen = {E.gf_pow(2, i) for i in range(255)}
    assert len(seen) == 255 and 0 not in seen
    for a in (1, 2, 3, 0x53, 0xFE, 0xFF):
        assert E.gf_mul(a, E.gf_inv(a)) == 1
    rng = np.random.default_rng(4)
    for a, b in rng.integers(0, 256, size=(64, 2)):
        assert E.gf_mul(int(a), int(b)) == _mul_schoolbook(int(a), int(b))
    log, exp = E._tables()
    rlog, rexp = R._tables()
    assert np.array_equal(log, rlog) and np.array_equal(exp, rexp)
    with pytest.raises(ZeroDivisionError):
        E.gf_inv(0)


def test_xtime_matches_scalar_mul_by_two():
    x = torch.arange(256, dtype=torch.uint8)
    got = E.xtime(x).numpy()
    assert [int(v) for v in got] == [E.gf_mul(2, i) for i in range(256)]
    words = np.arange(256, dtype=np.uint8).view(np.uint32)
    assert np.array_equal(E._xtime_np(words), R._xtime_np(words))
    assert np.array_equal(E._xtime_np(words).view(np.uint8), got)
    d = stripe(1, 256, seed=1)
    for p, q in (E.encode_pq_np(d), E.encode_pq(d, device="cpu")):
        assert np.array_equal(p, d[0]) and np.array_equal(q, d[0])


def test_q_is_gf_polynomial():
    k, ln = 5, 64
    sh = stripe(k, ln, seed=2)
    want = np.zeros(ln, dtype=np.uint8)
    for i in range(k):
        want ^= R._gf_mul_bytes(R._q_coeff(i, k), sh[i])
    for i in range(k):
        assert E._q_coeff(i, k) == R._q_coeff(i, k)
        assert np.array_equal(E._gf_mul_bytes(E._q_coeff(i, k), sh[i]),
                              R._gf_mul_bytes(R._q_coeff(i, k), sh[i]))
    assert np.array_equal(E.encode_pq_np(sh)[1], want)
    assert np.array_equal(E.encode_pq(sh, device="cpu")[1], want)


@pytest.mark.parametrize("c", [0, 1, 2, 0x1D, 0x80, 0xA7, 0xFF])
def test_gf_mul_const_same_on_both_backends(c):
    x = stripe(1, 64, seed=c)[0]
    want = R._gf_mul_bytes(c, x)
    got_np = E._gf_mul_const(c, x.view(np.uint32), np).view(np.uint8)
    got_t = E._gf_mul_const(c, torch.from_numpy(x), torch).numpy()
    assert np.array_equal(got_np, want) and np.array_equal(got_t, want)


@pytest.mark.parametrize("k,ln", [(1, 64), (2, 4096), (3, 4096), (6, 4096),
                                  (5, 0)])
def test_torch_encode_matches_jax_and_oracle(k, ln):
    sh = stripe(k, ln, seed=3 + k)
    p0, q0 = R.encode_pq_np(sh)
    p1, q1 = R.encode_pq(sh, device=True)   # JAX's jit, CPU backend
    p2, q2 = E.encode_pq(sh, device="cpu")
    _same([p2, q2], [p0, q0])
    _same([p2, q2], [p1, q1])
    _same(list(E.encode_pq_np(sh)), [p0, q0])


def test_encode_stripes_matches_oracle_per_stripe():
    """The node's batched encode: stripes of mixed width (a file's tail
    stripe is narrower), mixed lengths across several buckets, shards
    shorter than the stripe (zero padded) and empty shards."""
    rng = np.random.default_rng(7)
    stripes, want = [], []
    for s in range(60):
        k = int(rng.integers(1, 6))
        top = int(rng.choice([0, 7, 64, 300, 2048, 5000]))
        shards = [rng.integers(0, 256, size=int(rng.integers(0, top + 1)),
                               dtype=np.uint8).tobytes() for _ in range(k)]
        shard_len = -(-max(len(b) for b in shards) // 4) * 4
        padded = np.zeros((k, shard_len), dtype=np.uint8)
        for j, b in enumerate(shards):
            padded[j, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        stripes.append((shards, shard_len))
        want.append(R.encode_pq_np(padded))
    got = E.encode_stripes(stripes, device="cpu")
    assert len(got) == len(want)
    for (gp, gq), (wp, wq) in zip(got, want):
        _same([gp, gq], [wp, wq])
    assert E.encode_stripes([], device="cpu") == []


def test_encode_validation():
    with pytest.raises(ValueError, match="multiple of 4"):
        E.encode_pq(stripe(3, 62), device="cpu")
    with pytest.raises(ValueError, match="multiple of 4"):
        E.encode_pq_np(stripe(3, 62))
    with pytest.raises(ValueError, match="expected 4"):
        E.pq_horner(torch.zeros((3, 8), dtype=torch.uint8), 4)
    with pytest.raises(ValueError, match="expected 2"):
        E.pq_horner(torch.zeros((5, 3, 8), dtype=torch.uint8), 2, axis=1)
    with pytest.raises(TypeError, match="uint8"):
        E.xtime(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 4"):
        E.encode_stripes([([b"abc"], 3)], device="cpu")
    with pytest.raises(ValueError, match="longer than shard_len"):
        E.encode_stripes([([b"abcdefgh"], 4)], device="cpu")
    with pytest.raises(ValueError, match="no data shards"):
        E.encode_stripes([([], 4)], device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-CUDA "
                    "rule")
def test_device_entry_points_need_cuda_by_default():
    with pytest.raises(RuntimeError, match="CUDA"):
        E.encode_pq(stripe(2, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        E.encode_stripes([([b"abcd"], 4)])
    with pytest.raises(RuntimeError, match="CUDA"):
        E.recover_stripes([])


def _patterns(k):
    out = []
    for i in range(k):
        out.append(({i}, True, True))          # one data shard
        out.append(({i}, False, True))         # data + P lost
        out.append(({i}, True, False))         # data + Q lost
        for j in range(i + 1, k):
            out.append(({i, j}, True, True))   # two data shards
    return out


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_recover_every_single_and_double_erasure(k):
    ln = 512
    sh = stripe(k, ln, seed=k)
    p, q = E.encode_pq_np(sh)
    batch = []
    for missing, have_p, have_q in _patterns(k):
        data = [None if i in missing else sh[i].copy() for i in range(k)]
        pp = p.copy() if have_p else None
        qq = q.copy() if have_q else None
        got = E.recover_stripe(data, pp, qq)
        ref = R.recover_stripe(data, pp, qq)
        _same(got, list(sh))
        _same(got, ref)
        batch.append((data, pp, qq))
    for name, fn in RECOVER.items():
        for rec in fn(batch):
            _same(rec, list(sh))


def test_recover_rejects_three_losses():
    k = 4
    sh = stripe(k, 64, seed=9)
    p, q = E.encode_pq_np(sh)
    data = [None, None] + [sh[i] for i in range(2, k)]
    for fn in (E.recover_stripe, lambda d, p_, q_: RECOVER["numpy"](
            [(d, p_, q_)]), lambda d, p_, q_: RECOVER["torch"](
            [(d, p_, q_)])):
        with pytest.raises(ValueError):
            fn(data, None, q)
        with pytest.raises(ValueError):
            fn([None] * 3 + [sh[3]], p, q)


def test_zero_length_and_padding_invariance():
    sh = np.zeros((3, 0), dtype=np.uint8)
    for p, q in (E.encode_pq_np(sh), E.encode_pq(sh, device="cpu")):
        assert p.size == 0 and q.size == 0
    (p, q), = E.encode_stripes([([b"", b"", b""], 0)], device="cpu")
    assert p.size == 0 and q.size == 0
    sh = stripe(3, 64, seed=5)
    padded = np.zeros((3, 128), dtype=np.uint8)
    padded[:, :64] = sh
    p0, q0 = E.encode_pq_np(sh)
    for p1, q1 in (E.encode_pq_np(padded),
                   E.encode_pq(padded, device="cpu")):
        assert np.array_equal(p1[:64], p0) and not p1[64:].any()
        assert np.array_equal(q1[:64], q0) and not q1[64:].any()


@pytest.mark.parametrize("backend", sorted(RECOVER))
@pytest.mark.parametrize("k", [2, 3, 5, 8])
def test_recover_stripes_matches_per_stripe_oracle(k, backend):
    """Batched solve == recover_stripe (the port's and dfs_tpu's) on a
    mixed bag of stripes: random erasure patterns within the P+Q budget,
    two shard-length groups, an intact stripe in the middle."""
    rng = np.random.default_rng(100 + k)
    stripes, want = [], []
    for s in range(37):
        ln = 256 if s % 3 else 512
        sh = stripe(k, ln, seed=1000 * k + s)
        p, q = E.encode_pq_np(sh)
        pat = s % 5
        if pat == 0:
            missing, have_p, have_q = set(), True, True
        elif pat == 1:
            missing, have_p, have_q = {int(rng.integers(k))}, True, True
        elif pat == 2:
            missing, have_p, have_q = {int(rng.integers(k))}, False, True
        elif pat == 3:
            missing, have_p, have_q = {int(rng.integers(k))}, True, False
        else:
            missing = set(map(int, rng.choice(k, size=min(2, k),
                                              replace=False)))
            have_p = have_q = True
        data = [None if i in missing else sh[i].copy() for i in range(k)]
        stripes.append((data, p.copy() if have_p else None,
                        q.copy() if have_q else None))
        want.append(sh)
    got = RECOVER[backend](stripes)
    ref = R.recover_stripes(stripes)
    assert len(got) == len(stripes)
    for st, sh, rec, r in zip(stripes, want, got, ref):
        _same(rec, list(sh))
        _same(rec, r)
        _same(rec, E.recover_stripe(*st))


@pytest.mark.parametrize("backend", sorted(RECOVER))
def test_recover_stripes_validation(backend):
    fn = RECOVER[backend]
    sh = stripe(3, 64, seed=11)
    p, q = E.encode_pq_np(sh)
    with pytest.raises(ValueError, match="P\\+Q recovers at most 2"):
        fn([([None, None, None], p, q)])
    with pytest.raises(ValueError, match="unequal padded lengths"):
        fn([([None, sh[1], sh[2][:32]], p, q)])
    with pytest.raises(ValueError, match="multiple of 4"):
        fn([([None, sh[1][:62], sh[2][:62]], p[:62], q[:62])])
    assert fn([]) == []
    # mixed widths: the k=2 stripe groups separately
    sh2 = stripe(2, 64, seed=13)
    p2, q2 = E.encode_pq_np(sh2)
    got = fn([([sh[0], None, sh[2]], p, q), ([None, sh2[1]], p2, q2)])
    assert np.array_equal(got[0][1], sh[1])
    assert np.array_equal(got[1][0], sh2[0])


def test_recover_stripe_validates_lengths():
    sh = stripe(3, 64, seed=12)
    p, q = E.encode_pq_np(sh)
    with pytest.raises(ValueError, match="unequal padded lengths"):
        E.recover_stripe([None, sh[1], sh[2][:32]], p, q)
    with pytest.raises(ValueError, match="multiple of 4"):
        E.recover_stripe([None, sh[1][:62], sh[2][:62]], p[:62], q[:62])


def test_pad_bucket_is_the_reference_rule():
    """recover_stripes groups by this bucket; the reference computes it
    inline — the same lengths must land in the same groups."""
    for ln in list(range(0, 300, 4)) + [4092, 4096, 4100, 65536, 65540]:
        grain = max(4, 1 << max((ln - 1).bit_length() - 3, 2)) if ln else 4
        want = -(-ln // grain) * grain if ln else 4
        assert E._pad_bucket(ln) == want


def test_sharded_ec_step_matches_jax():
    """make_ec_step on a 4-slot CPU mesh against JAX's on 4 of the 8
    virtual CPU devices and the oracle: stripes split over the slots,
    parity bytes summed over them."""
    from dfs_tpu.parallel.mesh import make_mesh as ref_mesh
    from dfs_tpu.parallel.sharded_cdc import make_ec_step as ref_step
    from dfs_tpu.parallel.sharded_cdc import shard_ec_inputs as ref_shard

    from dfs_tpu_torch.parallel.mesh import make_mesh
    from dfs_tpu_torch.parallel.sharded_cdc import (make_ec_step,
                                                    shard_ec_inputs)

    k, ns, ln = 4, 16, 256
    stripes = np.random.default_rng(21).integers(
        0, 256, size=(ns, k, ln), dtype=np.uint8)
    words = stripes.view(np.uint32).reshape(ns, k, ln // 4)
    rmesh = ref_mesh(4)
    rp, rq, rn = ref_step(rmesh, k)(ref_shard(rmesh, words))
    mesh = make_mesh(4, device="cpu")
    p, q, n = make_ec_step(mesh, k)(shard_ec_inputs(mesh, words))
    assert p.dtype == q.dtype == torch.uint32
    p = p.view(torch.int32).numpy().view(np.uint8).reshape(ns, ln)
    q = q.view(torch.int32).numpy().view(np.uint8).reshape(ns, ln)
    assert np.array_equal(p, np.asarray(rp).view(np.uint8).reshape(ns, ln))
    assert np.array_equal(q, np.asarray(rq).view(np.uint8).reshape(ns, ln))
    for s in range(ns):
        _same([p[s], q[s]], list(E.encode_pq_np(stripes[s])))
    assert int(n) == int(rn) == 2 * ns * ln
    with pytest.raises(ValueError, match="does not split"):
        shard_ec_inputs(mesh, words[:6])


@pytest.mark.parametrize("ids", [[1, 2, 3], [1, 2, 3, 4, 5],
                                 [3, 10, 7, 12, 20, 4]])
def test_stripe_placement_matches_reference(ids):
    """Stripe holders bit for bit: the base int(file_id[:16], 16) +
    stripe * 2654435761 over the sorted member ids, shards consecutive."""
    mine, ref = RingMap.static(ids), RefRing.static(ids)
    srt = sorted(ids)
    rng = np.random.default_rng(len(ids))
    for _ in range(40):
        fid = rng.bytes(32).hex()
        for s in (0, 1, 7, 2269, 123_456):
            want = ref.ec_stripe_nodes(fid, s, len(ids))
            assert mine.ec_stripe_nodes(fid, s, len(ids)) == want
            assert len(set(want)) == len(ids)
            for j in range(len(ids)):
                assert mine.ec_shard_node(fid, s, j) \
                    == ref.ec_shard_node(fid, s, j)
                assert placement.ec_shard_node(fid, s, j, srt) \
                    == ref_placement.ec_shard_node(fid, s, j, srt)
