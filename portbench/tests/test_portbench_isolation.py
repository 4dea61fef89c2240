"""Nothing the benchmark runs imports JAX or dfs_tpu, and the reference
imports nothing of the port. Names are compared whole, by the part before
the first dot: ``dfs_tpu_torch`` is not ``dfs_tpu``."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import textwrap

import pytest

from portbench.tests.conftest import BENCH, CHECKOUT

FORBIDDEN = {"jax", "jaxlib", "flax", "dfs_tpu"}
FILES = sorted(BENCH.rglob("*.py"))


def _imported_tops(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            tops.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".", 1)[0])
    return tops


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_no_file_imports_jax_or_dfs_tpu(path):
    assert not _imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    tops = _imported_tops(path)
    assert not tops & (FORBIDDEN | {"dfs_tpu_torch", "torch"})
    assert tops <= {"__future__", "dataclasses", "hashlib", "numpy",
                    "portbench"}


def test_the_whole_top_level_name_is_compared():
    assert "dfs_tpu_torch".split(".", 1)[0] not in FORBIDDEN
    assert "dfs_tpu.ops".split(".", 1)[0] in FORBIDDEN


def test_a_run_loads_neither_jax_nor_dfs_tpu():
    """Imports every module of the harness, every metric reader, the
    program's path that a run and its replay load, and sees which
    top-level names ``sys.modules`` holds."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(CHECKOUT)!r})
        from portbench import (cluster, faults, generator, registry,
                               replay, run, smi, workcount)
        from portbench.reference import anchored
        bench = registry.load_benchmark()
        for m in bench["per_layer"]:
            registry.load_reader(m["name"])
        from dfs_tpu_torch import kernels
        from dfs_tpu_torch.cli import main
        frag = replay.make_fragmenter(
            registry.load_config("fastcdc-8k"), device="cpu")
        print(json.dumps(sorted({{m.split(".", 1)[0]
                                  for m in sys.modules}})))
        print(json.dumps(run.forbidden_modules()))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=CHECKOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops, found = (json.loads(line) for line in out.stdout.splitlines()[-2:])
    assert "dfs_tpu_torch" in tops and "portbench" in tops
    assert not set(tops) & FORBIDDEN
    assert found == []


def test_the_check_sees_a_forbidden_module():
    from portbench import run

    sys.modules["jaxlib_fake_probe"] = sys      # not a forbidden name
    sys.modules["jaxlib.fake"] = sys
    try:
        assert run.forbidden_modules() == ["jaxlib.fake"]
    finally:
        del sys.modules["jaxlib_fake_probe"], sys.modules["jaxlib.fake"]
