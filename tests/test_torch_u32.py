"""The port's uint32 helpers (int64-carried) against NumPy uint32, exact."""

import numpy as np
import pytest
import torch

from dfs_tpu_torch.utils import u32

EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
                  0xFFFFFFFF, 0x12345678, 0xDEADBEEF], dtype=np.uint32)


def _vectors(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    a = np.concatenate([EDGES, rng.integers(0, 2**32, n, dtype=np.uint32)])
    b = np.concatenate([EDGES[::-1],
                        rng.integers(0, 2**32, n, dtype=np.uint32)])
    return a, b


def _t(x: np.ndarray) -> torch.Tensor:
    return u32.widen(torch.from_numpy(x.view(np.int32)))


def _np(t: torch.Tensor) -> np.ndarray:
    return u32.narrow(t).view(torch.int32).numpy().view(np.uint32)


def test_widen_narrow_roundtrip():
    a, _ = _vectors()
    w = _t(a)
    assert w.dtype == torch.int64 and int(w.min()) >= 0
    assert int(w.max()) <= 0xFFFFFFFF
    np.testing.assert_array_equal(w.numpy(), a.astype(np.int64))
    np.testing.assert_array_equal(_np(w), a)
    # a uint32 tensor widens the same way as its int32 bit pattern
    tu = torch.from_numpy(a.view(np.int32)).view(torch.uint32)
    np.testing.assert_array_equal(u32.widen(tu).numpy(), a.astype(np.int64))


@pytest.mark.parametrize("op", ["add", "mul", "xor", "and"])
def test_binary_ops(op):
    a, b = _vectors(1)
    ta, tb = _t(a), _t(b)
    with np.errstate(over="ignore"):
        want = {"add": lambda: a + b, "mul": lambda: a * b,
                "xor": lambda: a ^ b, "and": lambda: a & b}[op]()
    got = {"add": lambda: u32.add(ta, tb), "mul": lambda: u32.mul(ta, tb),
           "xor": lambda: ta ^ tb, "and": lambda: ta & tb}[op]()
    np.testing.assert_array_equal(_np(got), want.astype(np.uint32))


def test_mul_by_constant_and_multi_add():
    a, b = _vectors(2)
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(
            _np(u32.mul(_t(a), 0x846CA68B)), a * np.uint32(0x846CA68B))
        np.testing.assert_array_equal(
            _np(u32.add(_t(a), _t(b), _t(a), 0x9E3779B1)),
            a + b + a + np.uint32(0x9E3779B1))


@pytest.mark.parametrize("n", [1, 3, 7, 8, 13, 16, 24, 31])
def test_shifts_and_rotr(n):
    a, _ = _vectors(3)
    ta = _t(a)
    np.testing.assert_array_equal(_np(u32.shr(ta, n)), a >> np.uint32(n))
    np.testing.assert_array_equal(_np(u32.shl(ta, n)), a << np.uint32(n))
    np.testing.assert_array_equal(
        _np(u32.rotr(ta, n)),
        (a >> np.uint32(n)) | (a << np.uint32(32 - n)))


def test_bswap_and_compare():
    a, b = _vectors(4)
    np.testing.assert_array_equal(_np(u32.bswap32(_t(a))), a.byteswap())
    ta, tb = _t(a), _t(b)
    np.testing.assert_array_equal((ta < tb).numpy(), a < b)
    np.testing.assert_array_equal(_np(torch.minimum(ta, tb)),
                                  np.minimum(a, b))


def test_fmix32_matches_numpy_oracle():
    from dfs_tpu_torch.ops.cdc_v2 import _M1, _M2, fmix32_np

    a, _ = _vectors(5)
    np.testing.assert_array_equal(
        _np(u32.fmix32(_t(a), int(_M1), int(_M2))), fmix32_np(a))
