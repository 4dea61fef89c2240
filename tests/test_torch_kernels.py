"""Each ported kernel's plain PyTorch version against the JAX twin that the
JAX tests pin equal to its Pallas kernel — same NumPy inputs from a seed,
exact equality (integer and hash outputs: tolerance zero). The CUDA kernels
themselves are held against these plain versions on the card
(chip_smoke.py, tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_select import LABELS as SELECT_LABELS


def _u32_tensor(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.uint32)
                            .view(np.int32)).view(torch.uint32)


def _np_u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy().view(np.uint32)


def test_k1_strip_chunk_states_matches_three_stage_twin():
    """K1 against gear_candidates_device + select_cuts_device +
    strip_states_xla, on the mixed-occupancy lanes of
    tests/test_sha256.py (full, partial, single-block, empty lanes);
    states compared on live lanes, as that test does."""
    from dfs_tpu.ops.cdc_v2 import (AlignedCdcParams, gear_candidates_device,
                                    select_cuts_device)
    from dfs_tpu.ops.sha256_strip import strip_states_xla

    from dfs_tpu_torch.ops.sha256_strip import strip_chunk_states

    cp = AlignedCdcParams(min_blocks=1, avg_blocks=2, max_blocks=3,
                          strip_blocks=4)           # 256 B lanes
    s = 128
    rng = np.random.default_rng(11)
    words = rng.integers(0, 2**32, size=(cp.strip_blocks * 16, s),
                         dtype=np.uint32)
    rb = np.zeros((s,), np.int32)
    rb[:100] = cp.strip_blocks
    rb[100:110] = rng.integers(1, cp.strip_blocks, size=10)
    rb[110] = 1   # single-block lane

    words_t = jax.device_put(words)
    cand = gear_candidates_device(words_t, cp)
    cutflag, since0 = select_cuts_device(cand, jax.device_put(rb), cp)
    cf0 = np.asarray(cutflag.astype(jnp.int32))
    states0 = np.asarray(strip_states_xla(words_t, jnp.asarray(cf0)))

    cf1, since1, states1 = strip_chunk_states(
        _u32_tensor(words), torch.from_numpy(rb), cp.seed, cp.mask,
        cp.min_blocks, cp.max_blocks)
    np.testing.assert_array_equal(cf1.numpy(), cf0)
    np.testing.assert_array_equal(since1.numpy(), np.asarray(since0))
    live = rb > 0
    s0 = states0.reshape(cp.strip_blocks, 8, s)
    s1 = _np_u32(states1).reshape(cp.strip_blocks, 8, s)
    np.testing.assert_array_equal(s1[:, :, live], s0[:, :, live])


def test_k1_default_geometry_selection_matches_twin():
    """The plain Gear + selection passes at the production chunk grid
    (min 32, avg 128, max 1024 blocks) on a 2048-block lane set, where the
    min-gate, the forced max cut and the lane tail all fire."""
    from dfs_tpu.ops.cdc_v2 import (AlignedCdcParams, gear_candidates_device,
                                    select_cuts_device)

    from dfs_tpu_torch.ops.cdc_v2 import gear_candidates, select_cuts

    cp = AlignedCdcParams()
    s = 8
    rng = np.random.default_rng(12)
    words = rng.integers(0, 2**32, size=(cp.strip_blocks * 16, s),
                         dtype=np.uint32)
    words[: 16 * 1500, 3] = 0          # a lane with no candidates: forced
    rb = np.array([2048, 2048, 1999, 2048, 1, 0, 700, 33], np.int32)
    cand0 = gear_candidates_device(jax.device_put(words), cp)
    cf0, since0 = select_cuts_device(cand0, jax.device_put(rb), cp)
    cand1 = gear_candidates(_u32_tensor(words), cp.seed, cp.mask)
    np.testing.assert_array_equal(cand1.numpy(), np.asarray(cand0))
    cf1, since1 = select_cuts(cand1, torch.from_numpy(rb), cp.min_blocks,
                              cp.max_blocks)
    np.testing.assert_array_equal(cf1.numpy(), np.asarray(cf0))
    np.testing.assert_array_equal(since1.numpy(), np.asarray(since0))


def test_k2_repack_lanes_matches_xla_twin():
    """K2 against repack_lanes_xla on the geometry of
    tests/test_cdc_anchored.py's repack test: every byte phase, starts at
    and around the 1024-word tiling, and the last in-bounds window."""
    from dfs_tpu.ops.repack import repack_lanes_xla

    from dfs_tpu_torch.ops.repack import repack_lanes

    lane_words = 1024
    m_total = 8 * 1024
    rng = np.random.default_rng(7)
    words = rng.integers(0, 2**32, size=m_total, dtype=np.uint32)
    hi = m_total - lane_words - 1
    offs = [0, 1, 5, 1023, 1024, 1025, hi, hi - 1, hi - 1023]
    offs += [int(x) for x in rng.integers(0, hi + 1, size=7)]
    w_off = np.asarray(offs, dtype=np.int32)
    sh8 = np.asarray([(i % 4) * 8 for i in range(len(offs))], np.uint32)

    want = np.asarray(repack_lanes_xla(jax.device_put(words),
                                       jax.device_put(w_off),
                                       jax.device_put(sh8), lane_words))
    got = repack_lanes(_u32_tensor(words), torch.from_numpy(w_off),
                       _u32_tensor(sh8), lane_words)
    np.testing.assert_array_equal(_np_u32(got), want)


@pytest.mark.parametrize("shape", [(128, 1024), (40, 96), (8, 33)])
def test_k3_bswap_transpose_matches_twin(shape):
    from dfs_tpu.ops.layout import bswap32

    from dfs_tpu_torch.ops.layout import bswap_transpose

    rng = np.random.default_rng(shape[1])
    x = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    want = np.asarray(bswap32(jax.device_put(x)).T)
    got = bswap_transpose(_u32_tensor(x))
    assert tuple(got.shape) == shape[::-1]
    np.testing.assert_array_equal(_np_u32(got), want)


def _dfs_params(kind):
    from dfs_tpu.ops.cdc_anchored import AnchoredCdcParams
    from dfs_tpu.ops.cdc_v2 import AlignedCdcParams

    if kind == "prod":
        return AnchoredCdcParams()
    return AnchoredCdcParams(
        chunk=AlignedCdcParams(min_blocks=2, avg_blocks=4, max_blocks=16,
                               strip_blocks=64),
        seg_min=2048, seg_max=4096, seg_mask=2047)


def _scan_twin(kind, tiles, n, start0, final):
    import dfs_tpu.ops.cdc_anchored as A

    params = _dfs_params(kind)
    m_tiles = tiles.shape[1]
    cap = m_tiles * A.TILE_BYTES // params.seg_min + 1
    return params, cap, np.asarray(A.make_select_fn(params, m_tiles, cap)(
        jnp.asarray(tiles), jnp.int32(start0), jnp.int32(n),
        jnp.bool_(final)))


def test_k4_select_walk_matches_scan_twin():
    """The plain walk against the JAX scan on every case of
    tests/test_torch_select.py: the two select tests' random cases of
    tests/test_cdc_anchored.py and the adversarial geometries."""
    from test_torch_select import CASES

    from dfs_tpu_torch.ops.select import select_walk

    for _, kind, tiles, n, start0, final in CASES:
        params, cap, want = _scan_twin(kind, tiles, n, start0, final)
        got = select_walk(torch.from_numpy(tiles),
                          torch.tensor([start0, n, int(final)],
                                       dtype=torch.int32),
                          cap, params.seg_min, params.seg_max)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("label", SELECT_LABELS)
def test_k4_kernel_model_matches_scan_twin(label):
    """The CUDA kernel's formulation (prefix max + one record a step, as
    NumPy) against the JAX scan: exact on every case before any card."""
    from test_torch_select import CASES, select_walk_model

    _, kind, tiles, n, start0, final = CASES[SELECT_LABELS.index(label)]
    params, cap, want = _scan_twin(kind, tiles, n, start0, final)
    for block in (2048, 8):          # the kernel's record blocks; tiny
        got = select_walk_model(tiles, start0, n, final, cap,
                                params.seg_min, params.seg_max, block=block)
        np.testing.assert_array_equal(got, want)


def test_gear_table_matches_numpy_table():
    from dfs_tpu.ops.cdc_v2 import g_table

    from dfs_tpu_torch.ops.cdc_v2 import gear_table

    for seed in (0x9D5D0CB2, 0, 0xFFFFFFFF):
        np.testing.assert_array_equal(
            gear_table(seed).numpy().astype(np.uint32), g_table(seed))


def test_wrappers_reject_unsupported_tensors():
    """A wrapper takes the plain version only for CPU tensors; anything
    else must reach the kernel's checks (and raise), never fall back."""
    from dfs_tpu_torch.ops.layout import bswap_transpose

    x = torch.zeros((4, 4), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        bswap_transpose(x)
