"""Cross-node trace stitching: merge per-node span lists into one tree
(a copy of dfs_tpu's ``obs/stitch.py``; the same spans render the same
text in either package).

Each node keeps only ITS spans of a trace (bounded ring,
:mod:`dfs_tpu_torch.obs`).
Stitching is post-hoc, Dapper-style: ``GET /trace?traceId=…`` on any
node gathers every peer's spans for the id (internal ``get_trace`` op)
and this module assembles the cross-node tree — parent ids link across
nodes because the client span's id travels in the RPC's ``trace`` field
and becomes the server span's parent.

Rendering is plain text for the ``trace <id>`` CLI subcommand: a
slow-request log (spans at or above the threshold, slowest first) above
the span tree. Spans whose parent is missing (evicted from a ring, or a
root) surface as top-level nodes rather than vanishing — an incomplete
trace must degrade to a forest, never to silence.
"""

from __future__ import annotations


def _dup_rank(sp: dict) -> tuple:
    """Total order over duplicate records of one span id: prefer the
    errored record, then the longer one, then the earlier start, then
    the smaller node — so which duplicate survives depends only on the
    records, never on the order peers answered a stitch query."""
    return (bool(sp.get("err")), sp.get("d", 0.0),
            -(sp.get("t0") or 0.0), -_node_key(sp))


def _node_key(sp: dict) -> float:
    node = sp.get("node")
    return float(node) if isinstance(node, (int, float)) \
        and not isinstance(node, bool) else float("inf")


def merge_spans(span_lists) -> list[dict]:
    """Concatenate per-node span lists, deduping by span id. Exact
    duplicates (a retried stitch query seeing the same ring entry twice,
    or a node's tail store and ring both answering) collapse trivially;
    CONFLICTING records under one id (a retried RPC that executed twice,
    a buggy peer) dedup deterministically via :func:`_dup_rank` — the
    stitched tree must not depend on peer answer order."""
    best: dict[str, dict] = {}
    order: list[str] = []
    for spans in span_lists:
        for sp in spans or []:
            sid = sp.get("s")
            if sid is None:
                continue   # no identity: cannot participate in a tree
            cur = best.get(sid)
            if cur is None:
                best[sid] = sp
                order.append(sid)
            elif _dup_rank(sp) > _dup_rank(cur):
                best[sid] = sp
    return [best[sid] for sid in order]


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}GiB"


def _line(sp: dict) -> str:
    parts = [sp.get("name", "?"), f"node={sp.get('node')}"]
    if sp.get("peer") is not None:
        parts.append(f"peer={sp['peer']}")
    parts.append(f"{sp.get('d', 0.0):.6f}s")
    if sp.get("bytes"):
        parts.append(_fmt_bytes(sp["bytes"]))
    if sp.get("err"):
        parts.append(f"ERR={sp['err']}")
    return " ".join(parts)


def render_tree(spans: list[dict], slow_s: float = 1.0) -> str:
    """One printable report per trace: header, slow-span log (>= slow_s,
    slowest first), then the span tree (children sorted by start time).
    """
    if not spans:
        return "(no spans — trace unknown or evicted from every ring)"
    tid = spans[0].get("t", "?")
    by_id = {sp.get("s"): sp for sp in spans}
    children: dict[str | None, list[dict]] = {}
    roots: list[dict] = []
    orphans: list[dict] = []
    for sp in spans:
        parent = sp.get("p")
        if parent is None:
            roots.append(sp)                       # true root
        elif parent in by_id and parent != sp.get("s"):
            children.setdefault(parent, []).append(sp)
        else:
            # parent never arrived (evicted ring entry, dead node) or a
            # degenerate self-parent: attach under the synthetic root
            # below rather than silently flattening into the real roots
            orphans.append(sp)
    for lst in children.values():
        lst.sort(key=lambda s: s.get("t0", 0.0))
    roots.sort(key=lambda s: s.get("t0", 0.0))
    orphans.sort(key=lambda s: s.get("t0", 0.0))

    nodes = sorted({sp.get("node") for sp in spans})
    t0 = min(sp.get("t0", 0.0) for sp in spans)
    t1 = max(sp.get("t0", 0.0) + sp.get("d", 0.0) for sp in spans)
    out = [f"trace {tid} — {len(spans)} spans, {len(nodes)} node(s) "
           f"{nodes}, {t1 - t0:.6f}s"]

    slow = sorted((sp for sp in spans if sp.get("d", 0.0) >= slow_s),
                  key=lambda s: -s.get("d", 0.0))
    if slow:
        out.append(f"slow spans (>= {slow_s:g}s):")
        out.extend(f"  ! {_line(sp)}" for sp in slow)

    emitted: set[str] = set()

    def walk(sp: dict, prefix: str, last: bool) -> None:
        sid = sp.get("s")
        if sid in emitted:
            return               # cycle guard: a span renders once
        emitted.add(sid)
        branch = "└─ " if last else "├─ "
        out.append(prefix + branch + _line(sp))
        kids = children.get(sid, [])
        ext = "   " if last else "│  "
        for i, kid in enumerate(kids):
            walk(kid, prefix + ext, i == len(kids) - 1)

    last_root = not orphans
    for i, root in enumerate(roots):
        walk(root, "", last_root and i == len(roots) - 1)
    # synthetic root for orphans — and for anything a parent CYCLE made
    # unreachable from any root: an incomplete or malformed trace must
    # degrade to a labeled forest, never drop spans silently
    orphan_ids = {id(sp) for sp in orphans}   # identity, not equality:
    # `sp in orphans` is a quadratic scan AND aliases equal-content
    # duplicate spans
    stray = [sp for sp in orphans + [s for s in spans
                                     if id(s) not in orphan_ids]
             if sp.get("s") not in emitted]
    if stray:
        out.append("└─ (orphaned — parent evicted, never arrived, or "
                   "cyclic)")
        for i, sp in enumerate(stray):
            walk(sp, "   ", i == len(stray) - 1)
    return "\n".join(out)
