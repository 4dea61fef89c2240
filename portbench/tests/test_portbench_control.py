"""The comparison that decides ``correct`` fails where it must. Each run
skips the harness's look for a card and drives the rest of a run (nodes,
agents, window, checks) on the CPU at a tiny size: sound, the run is
correct; with the control (the replication guarantee broken) or a fault
planted under the timed path, it is not. The same control runs on the
card at a cell's own size through ``--fault rf1``; its test here is
marked for the card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import CHECKOUT, write_tiny_registry


def _run(bench_file, registry, workload, *extra, seconds=4,
         timeout=600) -> dict:
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "2147483659", "--seconds", str(seconds), "--trace", "0",
         "--benchmark-file", str(bench_file), "--registry", str(registry),
         *extra], cwd=CHECKOUT, capture_output=True, text=True,
        timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("registry")
    return write_tiny_registry(root), root


def test_a_sound_run_is_correct(tiny):
    res = _run(*tiny, "tiny.tiny-incr", "--no-chip")
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


# fault -> a number that must leave its limit
@pytest.mark.parametrize("fault,number", [
    ("rf1", "replicas_missing"),            # the control
    ("unchanged", "replicas_missing"),      # placement leaves the store
    ("half_batch", "replicas_missing"),     # half of each batch left out
    ("altered", "setup_uploads_failed"),    # a digest altered at source
])
def test_a_fault_makes_the_run_incorrect(tiny, fault, number):
    res = _run(*tiny, "tiny.tiny-incr", "--no-chip", "--fault", fault)
    assert res["correct"] is False
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["restic-1m.backup-incr"])
def test_the_control_fails_on_the_card(cuda_card, cell):
    bench = CHECKOUT / "BENCHMARK.json"
    reg = CHECKOUT / "portbench"
    assert _run(bench, reg, cell, seconds=5, timeout=900)["correct"]
    res = _run(bench, reg, cell, "--fault", "rf1", seconds=5, timeout=900)
    assert res["correct"] is False
    assert res["checks"]["replicas_missing"]["value"] > 0
