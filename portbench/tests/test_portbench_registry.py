"""The registry finds every configuration, mix and metric by name, a new
one without an edit, and ``BENCHMARK.json`` keeps to the names and keys
the benchmark's contract allows."""

from __future__ import annotations

import json
import re

import pytest

from portbench import registry
from portbench.tests.conftest import CHECKOUT, write_tiny_registry

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_its_config_and_mix_by_name(cell):
    w = registry.workload(BENCH, cell)
    cfg = registry.load_config(w["config"])
    mix = registry.load_mix(w["traffic"])
    assert cfg["name"] == w["config"]
    assert cfg["replication_factor"] >= cfg["write_quorum"] >= 1
    assert mix["file_bytes"] > 0 and mix["block_bytes"] > 0


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader_that_agrees(metric):
    mod = registry.load_reader(metric["name"])
    assert (mod.SOURCE, mod.UNIT, mod.MOVES) == (
        metric["source"], metric["unit"], metric["moves"])


def test_config_files_are_the_benchmarks_and_hold_what_reduced_names():
    for c in BENCH["configs"]:
        cfg = json.loads((CHECKOUT / c["file"]).read_text())
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert cfg["source"] == c["source"]
        for key in c["reduced"]:
            assert key in cfg and key in cfg["reduced"]


def test_names_units_and_keys_keep_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(len(x) <= 200 and "\n" not in x for x in layers)
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert any(m["name"] == "setup_s" for m in
                   registry.cell_metrics(BENCH, w["name"], "end_to_end"))
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_new_config_mix_and_metric_are_found_without_an_edit(tmp_path):
    path = write_tiny_registry(tmp_path)
    (tmp_path / "metrics" / "new.metric.py").write_text(
        'SOURCE, UNIT, MOVES = "host_clock", "s", "upload_GiBps"\n'
        "def read(ctx):\n    return ctx.window_s\n")
    bench = registry.load_benchmark(path)
    w = registry.workload(bench, "tiny.tiny-incr")
    assert registry.load_config(w["config"], tmp_path)["name"] == "tiny"
    assert registry.load_mix(w["traffic"], tmp_path)["file_bytes"] \
        == 1536 * 1024
    mod = registry.load_reader("new.metric", tmp_path)
    assert mod.read(type("C", (), {"window_s": 7.0})()) == 7.0


def test_an_unknown_name_is_refused(tmp_path):
    with pytest.raises(registry.RegistryError):
        registry.load_config("no-such-config")
    with pytest.raises(registry.RegistryError):
        registry.workload(BENCH, "no-such-cell")
    with pytest.raises(registry.RegistryError):
        registry.load_benchmark(tmp_path / "absent.json")
