"""Replication-health census (a copy of dfs_tpu's ``obs/census.py``):
digest→owners accounting without moving
the catalog.

The storage-native questions of a census: *is every
digest replicated enough, where do the bytes live, which node holds
orphans?* Naively answering them means shipping every node's full digest
list to a coordinator — unbounded exactly when the cluster is large
enough to need the answer. This module implements the bounded protocol
instead:

1. **Summaries.** Each node's CAS reports per digest-prefix bucket
   (``chunks/<d[:2]>``, 256 buckets) a ``[count, bytes, xor-hash]``
   triple (:meth:`ChunkStore.inventory`, computed off-loop via the
   async CAS tier). The hash is the XOR of each member digest's
   leading 64 bits — order-free and incremental.
2. **Expectation.** The coordinator walks its own manifests (every node
   holds every manifest — the announce-to-all model) and computes, per
   node, the bucket summary it *should* see: replicated chunks map via
   ``replica_set``, EC shards via their stripe-pinned holders.
3. **Drill-down.** Only buckets whose (count, hash) differ from
   expectation are fetched as digest lists — bounded per node
   (``DRILL_BUCKET_CAP`` buckets x the inventory's per-bucket list
   cap); a matching summary proves membership equality without a list
   (modulo 64-bit XOR collisions, which the count+bytes cross-check
   makes an engineering non-event for diagnosis purposes).
4. **Findings.** Observed copies per digest → a replication-factor
   histogram plus BOUNDED lists of under-replicated / orphaned /
   over-replicated digests (``CensusConfig.max_listed`` each).

Dead peers degrade the census to a partial result, never an error
(the ``/trace`` / ``/doctor`` discipline): a copy expected on a peer
that did not answer counts as *unknown*, not missing, so a one-node
outage reads as one ``dead_peer`` doctor finding — not a million
under-replicated digests.

The census reflects the COORDINATOR's manifest view: a node that
slept through an announce will flag that file's chunks as orphans
until manifest anti-entropy converges — run ``repair`` first when in
doubt.
"""

from __future__ import annotations

from typing import Mapping, Sequence

from dfs_tpu_torch.store.cas import ChunkStore

# mismatched buckets drilled per node per census; beyond it the census
# reports `uncheckedBuckets` instead of fetching more lists — the
# boundedness contract (256 buckets exist, so 64 covers any localized
# divergence; a node diverging in >64 buckets is wholesale-broken and
# the summary counts already say so)
DRILL_BUCKET_CAP = 64


def _prefix(digest: str) -> str:
    return digest[:ChunkStore.PREFIX_HEX]


def expected_state(manifests: Sequence, ids: list[int], rf: int
                   ) -> tuple[dict[str, tuple[int, ...]], dict[str, int],
                              int]:
    """Walk manifests into the census expectation over a STATIC
    membership list: ``digest -> expected holder node ids`` (replica
    set, or EC stripe-pinned holders), ``digest -> byte length``, and
    the logical byte total (sum of manifest sizes — the numerator of
    the dedup ratio). Pure CPU: run via ``asyncio.to_thread``. The
    epoch-aware runtime path is :func:`expected_state_ring`; this is
    its fixed-membership shape (tests, benches)."""
    from dfs_tpu_torch.ring import RingMap

    union, _cur, lengths, logical = expected_state_ring(
        manifests, RingMap.static(ids), None, rf)
    return union, lengths, logical


def expected_state_ring(manifests: Sequence, ring, prev_ring, rf: int
                        ) -> tuple[dict[str, tuple[int, ...]],
                                   dict[str, tuple[int, ...]],
                                   dict[str, int], int]:
    """Epoch-aware census expectation: walk
    manifests against the ring's owner map. Returns ``(expected_union,
    expected_current, lengths, logical)`` where ``expected_current``
    maps each digest to its CURRENT-epoch owners (the replication
    target the under-check judges against) and ``expected_union`` adds
    the PREVIOUS epoch's owners while a migration window is open —
    copies still sitting at their old home are EXPECTED there
    mid-move, so one rebalance cannot light up thousands of phantom
    under-/over-replication or orphan findings. With ``prev_ring``
    None the two maps are the same object."""
    # EC placement reuses the runtime's memoized stripe->holder map;
    # imported lazily because the runtime imports this module back
    from dfs_tpu_torch.node.runtime import ec_placement_map, ec_shard_items

    union: dict[str, tuple[int, ...]] = {}
    current: dict[str, tuple[int, ...]] = union if prev_ring is None \
        else {}
    lengths: dict[str, int] = {}
    logical = 0

    def add(table: dict, d: str, holders) -> None:
        # UNION across manifests: a digest deduped between two files
        # with different placements (two EC stripes, or EC + replica)
        # legitimately lives at both — the write path probes and fills
        # EACH file's targets, so overwriting one expectation with the
        # other would read the real extra copies as over-replicated
        cur = table.get(d)
        table[d] = tuple(sorted(set(cur) | set(holders))) \
            if cur else tuple(sorted(holders))

    for m in manifests:
        logical += m.size
        if m.ec is not None:
            pl = ec_placement_map(m, ring)
            pl_prev = ec_placement_map(m, prev_ring) \
                if prev_ring is not None else None
            for d, ln in ec_shard_items(m):
                lengths.setdefault(d, ln)
                add(current, d, pl[d])
                if pl_prev is not None:
                    add(union, d, tuple(pl[d]) + tuple(
                        pl_prev.get(d, ())))
            continue
        for c in m.chunks:
            lengths.setdefault(c.digest, c.length)
            owners = ring.owners(c.digest, rf)
            add(current, c.digest, owners)
            if prev_ring is not None:
                add(union, c.digest,
                    owners + prev_ring.owners(c.digest, rf))
    return union, current, lengths, logical


def summarize_expected(expected: Mapping[str, tuple[int, ...]],
                       lengths: Mapping[str, int]
                       ) -> dict[int, dict[str, list]]:
    """Per-node expected bucket table ``{node: {prefix: [count, bytes,
    hash]}}`` — the comparison side of each node's observed
    inventory."""
    out: dict[int, dict[str, list]] = {}
    for d, holders in expected.items():
        p = _prefix(d)
        stamp = ChunkStore.digest_stamp(d)
        ln = lengths[d]
        for nid in holders:
            buckets = out.setdefault(nid, {})
            b = buckets.get(p)
            if b is None:
                b = buckets[p] = [0, 0, 0]
            b[0] += 1
            b[1] += ln
            b[2] ^= stamp
    return out


def diff_buckets(exp: Mapping[str, list], got: Mapping[str, list]
                 ) -> list[str]:
    """Prefixes whose (count, bytes, hash) summary differs between the
    expected and observed tables — the buckets worth drilling. A
    prefix present on only one side differs by definition. Bytes are
    part of the check on purpose: a truncated chunk file keeps its
    name (count and xor unchanged) and only the byte sum betrays it,
    and the three-way match is what makes a 64-bit XOR collision an
    engineering non-event."""
    out = []
    for p in set(exp) | set(got):
        e = exp.get(p, (0, 0, 0))
        g = got.get(p, (0, 0, 0))
        if e[0] != g[0] or e[1] != g[1] or e[2] != g[2]:
            out.append(p)
    return sorted(out)


def build_report(expected: Mapping[str, tuple[int, ...]],
                 lengths: Mapping[str, int],
                 inventories: Mapping[int, dict | None],
                 drilled: Mapping[int, Mapping[str, Sequence[str]]],
                 max_listed: int,
                 cur_expected: Mapping[str, tuple[int, ...]]
                 | None = None) -> dict:
    """Cross-reference expectation against observed inventories into
    the census findings. ``inventories[nid] is None`` = the peer did
    not answer (its expected copies count as *unknown*, not missing).
    ``drilled[nid][prefix]`` is the actual digest list for a bucket
    whose summary mismatched; buckets with MATCHING summaries are taken
    as holding exactly their expected members (that is what the
    count+hash equality certifies).

    Mid-migration (``cur_expected`` differing from ``expected``):
    ``expected`` is the union of current- and previous-epoch owners (a
    copy still at its old home is expected there, not an orphan or an
    extra), while the under-replication bar is the CURRENT epoch's
    owner count — digests whose copy count sits between the two maps
    are IN-FLIGHT (``inFlightTotal``), not findings."""
    if cur_expected is None:
        cur_expected = expected
    exp_by_node = summarize_expected(expected, lengths)
    # per-node per-prefix expected membership, built ONCE (the naive
    # walk-all-digests-per-bucket comparison is quadratic in catalog
    # size — this pass is the whole-report cost driver)
    members: dict[int, dict[str, set[str]]] = {}
    for d, holders in expected.items():
        p = _prefix(d)
        for nid in holders:
            members.setdefault(nid, {}).setdefault(p, set()).add(d)
    observed: dict[str, int] = {d: 0 for d in expected}
    unknown: dict[str, int] = {d: 0 for d in expected}
    orphans: dict[str, list[int]] = {}
    over_holders: dict[str, list[int]] = {}
    unchecked = 0

    for nid, inv in inventories.items():
        exp_members = members.get(nid, {})
        if inv is None:   # dead peer: its expected copies are unknown
            for ds in exp_members.values():
                for d in ds:
                    unknown[d] += 1
            continue
        got_buckets = inv.get("buckets") or {}
        node_drill = drilled.get(nid) or {}
        mism = set(diff_buckets(exp_by_node.get(nid, {}), got_buckets))
        for p, ds in exp_members.items():
            if p not in mism:
                # summary match == membership match: every expected
                # digest of this bucket is present on the node
                for d in ds:
                    observed[d] += 1
            elif p in node_drill:
                held = set(node_drill[p])
                for d in ds:
                    if d in held:
                        observed[d] += 1
            else:
                # beyond the drill cap (or the drill answer went
                # missing): expected digests here are unknown — honest
                # partiality beats guessing either way
                unchecked += 1
                for d in ds:
                    unknown[d] += 1
        unchecked += sum(1 for p in mism
                         if p not in exp_members and p not in node_drill)
        # drilled lists also reveal what the node holds BEYOND its
        # expectation: orphans (referenced by no manifest) and extra
        # copies of known digests (handoff leftovers — over-replication)
        for p, names in node_drill.items():
            exp_here = exp_members.get(p, ())
            for d in names:
                if d in exp_here:
                    continue
                if d in expected:
                    observed[d] += 1
                    over_holders.setdefault(d, []).append(nid)
                else:
                    orphans.setdefault(d, []).append(nid)

    histogram: dict[str, int] = {}
    under: list[dict] = []
    over: list[dict] = []
    n_under = n_over = n_inflight = 0
    for d in sorted(expected):
        want = len(cur_expected.get(d, expected[d]))   # current-epoch bar
        cap = len(expected[d])                          # union cap
        have = observed[d]
        histogram[str(have)] = histogram.get(str(have), 0) + 1
        # unknown copies (dead peers, undrilled buckets) count toward
        # the want before a digest is called under-replicated: a dead
        # node is a dead_peer finding, not a million missing replicas
        if have + unknown[d] < want:
            n_under += 1
            if len(under) < max_listed:
                under.append({"digest": d, "expected": want,
                              "observed": have,
                              "holders":
                              list(cur_expected.get(d, expected[d]))})
        elif have > cap:
            n_over += 1
            if len(over) < max_listed:
                over.append({"digest": d, "expected": cap,
                             "observed": have,
                             "extraOn": sorted(over_holders.get(d, []))})
        elif cap != want and have != want:
            # migration pending for this digest: enough copies exist
            # (old + new homes), placement just hasn't converged —
            # a rebalance in flight, not a data-health finding
            n_inflight += 1
    orphan_list = [{"digest": d, "nodes": sorted(ns)}
                   for d, ns in sorted(orphans.items())][:max_listed]
    return {
        "digests": len(expected),
        "replicationHistogram": histogram,
        "underReplicated": under, "underReplicatedTotal": n_under,
        "orphaned": orphan_list, "orphanedTotal": len(orphans),
        "overReplicated": over, "overReplicatedTotal": n_over,
        "inFlightTotal": n_inflight,
        "uncheckedBuckets": unchecked,
    }


# ------------------------------------------------------------------ #
# CLI rendering (census / df subcommands)
# ------------------------------------------------------------------ #

def _gib(n) -> str:
    return f"{n / 2**30:.2f}GiB" if isinstance(n, (int, float)) else "?"


def render_census(report: dict) -> str:
    """Plain-text census for the ``census`` CLI subcommand."""
    lines = [f"cluster census — {report.get('digests', 0)} referenced "
             f"digest(s), {report.get('peersFailed', 0)} peer(s) "
             "unreachable"]
    hist = report.get("replicationHistogram") or {}
    if hist:
        lines.append("  copies histogram: " + "  ".join(
            f"{c}x:{n}" for c, n in sorted(hist.items(),
                                           key=lambda kv: int(kv[0]))))
    for key, label in (("underReplicated", "under-replicated"),
                       ("orphaned", "orphaned"),
                       ("overReplicated", "over-replicated")):
        total = report.get(f"{key}Total", 0)
        if not total:
            continue
        lines.append(f"! {label}: {total} digest(s)")
        for f in report.get(key) or []:
            where = f.get("nodes") or f.get("holders") \
                or f.get("extraOn") or []
            lines.append(f"    {f['digest'][:16]}… "
                         + (f"observed {f['observed']}/{f['expected']} "
                            if "observed" in f else "")
                         + f"nodes {where}")
    if report.get("inFlightTotal"):
        lines.append(f"  {report['inFlightTotal']} digest(s) in flight "
                     f"(rebalance to ring epoch "
                     f"{report.get('ringEpoch', '?')} in progress)")
    if report.get("uncheckedBuckets"):
        lines.append(f"  ({report['uncheckedBuckets']} diverging "
                     "bucket(s) beyond the drill cap left unchecked)")
    if not any(report.get(f"{k}Total") for k in
               ("underReplicated", "orphaned", "overReplicated")):
        lines.append("every referenced digest at expected replication")
    return "\n".join(lines)


def render_df(report: dict) -> str:
    """Per-node + cluster capacity table for the ``df`` CLI subcommand
    — the storage-native ``df(1)``."""
    cap = report.get("capacity") or {}
    lines = ["node       chunks      cas        disk free   disk total"]
    for nid, n in sorted((cap.get("nodes") or {}).items(),
                         key=lambda kv: int(kv[0])):
        if not n:
            lines.append(f"{nid:<10} NO ANSWER")
            continue
        lines.append(
            f"{nid:<10} {n.get('casChunks', 0):<11} "
            f"{_gib(n.get('casBytes', 0)):<10} "
            f"{_gib(n.get('diskFreeBytes')):<11} "
            f"{_gib(n.get('diskTotalBytes'))}")
    lines.append(
        f"cluster: cas={_gib(cap.get('clusterCasBytes', 0))} "
        f"chunks={cap.get('clusterChunks', 0)} "
        f"logical={_gib(cap.get('logicalBytes', 0))} "
        f"unique={_gib(cap.get('uniqueBytes', 0))} "
        f"dedup={cap.get('dedupRatio', 0.0):.3f}x")
    return "\n".join(lines)


__all__ = ["DRILL_BUCKET_CAP", "build_report", "diff_buckets",
           "expected_state", "expected_state_ring", "render_census",
           "render_df", "summarize_expected"]
