"""The work counts of ``kernels.chunkhash_roofline`` on hand-checked
inputs, and the trace reader on a hand-made trace."""

from __future__ import annotations

import json

import pytest

from portbench import replay, workcount


def test_sha256_operations_a_block_follow_fips_180_4():
    # schedule: 48 words x (sigma0 5 + sigma1 5 + 3 adds)
    assert workcount.SHA256_SCHEDULE_OPS == 624
    # a round: Sigma1 5, Ch 4, T1's 4 adds, Sigma0 5, Maj 5, T2's add,
    # e and a 1 each
    assert workcount.SHA256_ROUND_OPS == 26
    assert workcount.SHA256_OPS_PER_BLOCK == 624 + 64 * 26 + 8 == 2296


@pytest.mark.parametrize("length,blocks", [(0, 1), (55, 1), (56, 2),
                                           (64, 2), (119, 2), (120, 3)])
def test_padded_blocks(length, blocks):
    assert workcount.padded_blocks(length) == blocks


def test_work_of_a_tiny_input_by_hand():
    w = workcount.work(128, [55, 73])
    # anchor 26 x 128, Gear 98 x 2 blocks, SHA-256 2296 x (1 + 2) blocks
    assert w["ops"] == 26 * 128 + 98 * 2 + 2296 * 3 == 10412
    assert w["bytes"] == 128 + 2 * 48
    assert w["sha256_blocks"] == 3
    assert w["bound_by"] == "operations"
    assert w["bound_s"] == pytest.approx(10412 / (132 * 64 * 1.98e9))


def test_work_refuses_lengths_that_do_not_cover_the_input():
    with pytest.raises(ValueError):
        workcount.work(100, [50, 49])


def test_trace_reader_unions_device_ops_and_names_the_gaps(tmp_path):
    ev = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 5, "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "name": "cp", "ts": 40,
           "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 100, "dur": 5},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 10,
           "dur": 40},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 26, "dur": 4}]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    r = replay.read_trace(p)
    assert r["busy_s"] == pytest.approx(30e-6)
    assert r["device_ops"][0] == ["k1", pytest.approx(15e-6)]
    # gaps 15..40 (middle 27.5: inside the launch, the innermost event)
    # and 50..100 (middle 75: no host event)
    assert r["idle_gaps"] == [
        ["host outside torch ops", pytest.approx(50e-6)],
        ["cudaLaunchKernel", pytest.approx(25e-6)]]
