"""Every public name of dfs_tpu has a counterpart in the port.

Walks the AST of every ``dfs_tpu/**/*.py`` and, for each public top-level
function and class and each public method of a public class, asserts that
the port's module of the same path defines the same name: a method may
come from a base class anywhere in the port, or be a class attribute or
an attribute ``__init__`` sets there (dfs_tpu's ``name`` property is a class attribute of the
port's). Two tables say where the port differs on purpose, and are the
whole list of such differences:

- ``MODULES``: modules whose port counterpart has another path (the
  ``*_jax.py`` modules and the Pallas and TPU modules);
- ``COUNTERPARTS``: names of dfs_tpu's that exist for JAX, Pallas or the
  TPU, each with the name in the port that does its work.

Beyond those, a name with ``Tpu`` in it has its counterpart with ``Cuda``
in its place. Parses source only: imports neither package.
"""

import ast
import functools
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "dfs_tpu", ROOT / "dfs_tpu_torch"

MODULES = {
    "ops/gear_jax.py": "ops/gear.py",
    "ops/pack_jax.py": "ops/pack.py",
    "ops/sha256_jax.py": "ops/sha256.py",
    "ops/select_pallas.py": "ops/select.py",
    "fragmenter/cdc_tpu.py": "fragmenter/cdc_cuda.py",
}

# (dfs_tpu module, name) -> (port module, name)
COUNTERPARTS = {
    # the TPU probe and the link-tracking TPU/CPU switch: the port picks
    # its engine once, in get_fragmenter ("auto" is the card's engine,
    # and without a card it raises)
    ("fragmenter/base.py", "tpu_available"):
        ("__init__.py", "resolve_device"),
    ("fragmenter/base.py", "AutoAnchoredFragmenter"):
        ("fragmenter/cdc_anchored.py", "AnchoredCudaFragmenter"),
    ("fragmenter/base.py", "AutoAnchoredFragmenter.engine"):
        ("fragmenter/base.py", "get_fragmenter"),
    ("fragmenter/base.py", "AutoAnchoredFragmenter.reprobe_now"):
        ("fragmenter/base.py", "get_fragmenter"),
    ("fragmenter/cdc_anchored_sharded.py", "ShardedAnchoredCdcFragmenter"):
        ("fragmenter/cdc_anchored_sharded.py",
         "ShardedAnchoredCudaFragmenter"),
    # jit-compiled builders: the port's functions run eagerly
    ("ops/cdc_anchored.py", "make_anchor_fn"):
        ("ops/cdc_anchored.py", "anchor_tiles"),
    ("ops/cdc_anchored.py", "make_descriptor_fn"):
        ("ops/cdc_anchored.py", "descriptors"),
    ("ops/cdc_anchored.py", "make_anchored_segment_fn"):
        ("ops/cdc_anchored.py", "make_chain_fn"),
    ("ops/cdc_anchored.py", "make_select_fn"):
        ("ops/select.py", "select_walk_plain"),
    ("ops/cdc_anchored.py", "make_select"):
        ("ops/select.py", "select_walk"),
    ("ops/cdc_v2.py", "gear_candidates_device"):
        ("ops/cdc_v2.py", "gear_candidates"),
    ("ops/cdc_v2.py", "select_cuts_device"):
        ("ops/cdc_v2.py", "select_cuts"),
    ("ops/cdc_pipeline.py", "cut_capacity"):
        ("ops/cdc_v2.py", "cut_capacity"),
    ("ops/cdc_pipeline.py", "digests_to_hex"):
        ("ops/cdc_v2.py", "digests_to_hex"),
    ("ops/ec.py", "xtime_device"): ("ops/ec.py", "xtime"),
    # XLA twins of Pallas kernels: the plain PyTorch versions
    ("ops/repack.py", "repack_lanes_xla"):
        ("ops/repack.py", "repack_lanes_plain"),
    ("ops/sha256_strip.py", "strip_states_xla"):
        ("ops/sha256_strip.py", "strip_states_plain"),
    # Pallas kernels and their "can the Pallas path run" predicates: the
    # CUDA wrappers, which check their tensors and raise
    ("ops/select_pallas.py", "make_select_fn_pallas"):
        ("ops/select.py", "select_walk"),
    ("ops/select_pallas.py", "select_pallas_supported"):
        ("ops/select.py", "select_walk"),
    ("ops/repack.py", "repack_supported"): ("kernels.py", "check_cuda"),
    # the cut-state gather and the FIPS finalize of the anchored chain
    ("ops/sha256_strip.py", "gather_cut_states"):
        ("ops/cdc_anchored.py", "compact_half"),
    ("ops/sha256_strip.py", "pad_finalize_device"):
        ("ops/cdc_anchored.py", "compact_half"),
    ("ops/sha256_strip.py", "cut_state_rows"):
        ("ops/sha256.py", "cut_state_rows"),
}

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _public(name: str) -> bool:
    return not name.startswith("_")


def _classes(tree: ast.Module) -> dict[str, ast.ClassDef]:
    return {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}


def _members(cls: ast.ClassDef) -> set[str]:
    """Methods, class attributes and the ``self.x`` attributes that
    ``__init__`` sets."""
    out = set()
    for n in cls.body:
        if isinstance(n, _FUNCS):
            out.add(n.name)
            if n.name == "__init__":
                out |= {a.attr for a in ast.walk(n)
                        if isinstance(a, ast.Attribute)
                        and isinstance(a.ctx, ast.Store)
                        and isinstance(a.value, ast.Name)
                        and a.value.id == "self"}
        elif isinstance(n, ast.Assign):
            out |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
    return out


def _base_names(cls: ast.ClassDef) -> list[str]:
    return [b.id if isinstance(b, ast.Name) else b.attr for b in cls.bases
            if isinstance(b, (ast.Name, ast.Attribute))]


@functools.cache
def _parse(root: Path) -> dict[str, ast.Module]:
    return {p.relative_to(root).as_posix(): ast.parse(p.read_text(), str(p))
            for p in sorted(root.rglob("*.py"))}


@functools.cache
def _port_index():
    trees = _parse(PORT)
    classes: dict[str, list[ast.ClassDef]] = {}
    for tree in trees.values():
        for name, cls in _classes(tree).items():
            classes.setdefault(name, []).append(cls)
    return trees, classes


_MEMBERS: dict[int, set[str]] = {}


def _all_members(cls: ast.ClassDef, classes) -> set[str]:
    """A port class's members with those of its bases in the port."""
    if id(cls) in _MEMBERS:
        return _MEMBERS[id(cls)]
    seen, todo, out = set(), [cls], set()
    while todo:
        c = todo.pop()
        if id(c) in seen:
            continue
        seen.add(id(c))
        out |= _members(c)
        for b in _base_names(c):
            todo += classes.get(b, [])
    _MEMBERS[id(cls)] = out
    return out


@functools.cache
def _top_names(tree: ast.Module) -> frozenset[str]:
    """Top-level functions, classes and assigned names of a module."""
    return frozenset(
        [n.name for n in tree.body
         if isinstance(n, _FUNCS + (ast.ClassDef,))]
        + [t.id for n in tree.body if isinstance(n, ast.Assign)
           for t in n.targets if isinstance(t, ast.Name)])


def _defines(tree: ast.Module, name: str, classes) -> bool:
    cls_name, _, member = name.partition(".")
    if not member:
        return cls_name in _top_names(tree)
    cls = _classes(tree).get(cls_name)
    return cls is not None and member in _all_members(cls, classes)


def _ref_names(tree: ast.Module) -> list[str]:
    out = []
    for n in tree.body:
        if isinstance(n, _FUNCS) and _public(n.name):
            out.append(n.name)
        elif isinstance(n, ast.ClassDef) and _public(n.name):
            out.append(n.name)
            out += [f"{n.name}.{m.name}" for m in n.body
                    if isinstance(m, _FUNCS) and _public(m.name)]
    return out


def _counterpart(module: str, name: str) -> tuple[str, str]:
    if (module, name) in COUNTERPARTS:
        return COUNTERPARTS[(module, name)]
    cls, _, member = name.partition(".")
    if member and (module, cls) in COUNTERPARTS:
        port_module, port_cls = COUNTERPARTS[(module, cls)]
        return port_module, f"{port_cls}.{member}"
    return MODULES.get(module, module), name.replace("Tpu", "Cuda")


def test_every_public_name_of_dfs_tpu_has_a_counterpart_in_the_port():
    ref = _parse(REF)
    trees, classes = _port_index()
    assert len(ref) > 80 and len(trees) > 80
    missing, used = [], set()
    for module, tree in ref.items():
        for name in _ref_names(tree):
            key = (module, name)
            if key in COUNTERPARTS:
                used.add(key)
            port_module, port_name = _counterpart(module, name)
            port_tree = trees.get(port_module)
            if port_tree is None or not _defines(port_tree, port_name,
                                                 classes):
                missing.append(f"dfs_tpu/{module}:{name} -> "
                               f"dfs_tpu_torch/{port_module}:{port_name}")
    assert not missing, "\n".join(missing)
    # the tables name only what exists on both sides
    assert used == set(COUNTERPARTS), set(COUNTERPARTS) - used
    assert all(m in ref and MODULES[m] in trees for m in MODULES)


def test_the_seven_names_the_port_lacked_until_now():
    trees, classes = _port_index()
    for module, name in (("comm/wire.py", "frame_size"),
                         ("comm/wire.py", "send_msg"),
                         ("comm/wire.py", "read_msg"),
                         ("comm/wire.py", "FrameServerProtocol.send_frame"),
                         ("cli/client.py", "NodeClient.scrub"),
                         ("config.py", "PeerAddr.http_base"),
                         ("config.py", "ClusterConfig.n_nodes")):
        assert _defines(trees[module], name, classes), (module, name)
    init = trees["comm/__init__.py"]
    reexported = {a.name for n in init.body
                  if isinstance(n, ast.ImportFrom) for a in n.names}
    assert {"send_msg", "read_msg"} <= reexported
