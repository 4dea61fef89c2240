"""Cluster doctor (a copy of dfs_tpu's ``obs/doctor.py``): a rule table that names known pathologies.

Diagnosing a sick cluster by hand means correlating ``/metrics``,
``/events`` and ``/trace`` across N nodes. The doctor automates the
first pass: ``GET /doctor?cluster=1`` on any node fans out (bounded,
partial-on-dead-peers — exactly like ``/trace``) collecting each peer's
snapshot (metric summary, recent incidents, disk headroom, config
hash, wall clock), then :func:`diagnose` walks the rule table below and
names what it sees WITH the evidence — a starting hypothesis, not a
verdict.

Rules (each produces ``{"rule", "severity", "peers", "evidence"}``):

- ``dead_peer``      — a peer did not answer the doctor probe, or any
                       node's health registry reports it dead.
- ``slow_peer``      — a peer's observed RPC latency (mean seconds/call
                       aggregated across every reporting node's client
                       table, WINDOWED via recentSeconds/recentCount so
                       a recovered peer's dead-period timeouts age out)
                       exceeds 3x the median of the other peers and an
                       absolute floor (50 ms) — relative, so a
                       uniformly-loaded cluster is not all "slow".
- ``shed_storm``     — admission gates shed requests (503s served)
                       RECENTLY (the gate's ~60 s ``shedRecent``
                       window, not the since-boot counter — a transient
                       overload must not latch the diagnosis red
                       forever; old-build peers without the windowed
                       gauge fall back to the lifetime total).
- ``credit_starvation`` — ingest chunking spent significant time
                       blocked on byte credits (placement is the
                       bottleneck) on some node.
- ``cache_thrash``   — a serve cache with enough traffic to judge is
                       evicting heavily at a low hit rate (budget too
                       small for the working set).
- ``clock_skew``     — a peer's reported wall clock differs by more
                       than 2 s from the coordinator's clock at the
                       moment that peer's answer arrived (LWW tombstone
                       ordering and journal timestamps both lean on
                       wall clocks).
- ``config_drift``   — config fingerprints (sha256 over the shared
                       NodeConfig fields — node-local identity fields
                       excluded) differ across nodes: a rolling restart
                       left the cluster half-configured.
- ``loop_lag``       — a node's sentinel observed event-loop stalls at
                       or beyond its threshold within its recency
                       window (``recentMaxLagS``, ~60 s — same
                       no-latching rationale as ``shed_storm``;
                       lifetime ``maxLagS`` is the old-build fallback).
                       Something occupied the loop; see its journal
                       for when.
- ``capacity_trend`` — trend-aware disk-full ETA: a node's CAS
                       byte gauge is growing (history-sampler slope,
                       ``capacity.growthBytesPerS``) fast enough that
                       its disk free space runs out within 24 h
                       (warning) or 1 h (critical). Needs the census
                       history sampler on; quiet otherwise.
- ``underreplication`` — CRITICAL: digests below their replication
                       factor — the node's live repair queue
                       (``underReplicated``) or a recent census's
                       findings (``census.underReplicated``). Durability
                       is the one promise this system makes; this rule
                       is the loudest one in the table.
- ``epoch_mismatch`` — nodes report different ring epochs: a
                       membership change did not reach everyone — the
                       epoch-on-RPC gossip converges the stale side on
                       first contact, but a persistently split epoch
                       view means a partitioned/firewalled node placing
                       by an old map.
- ``rebalance_stuck`` — a node has been migrating to a new ring epoch
                       with no movement progress for
                       ``REBALANCE_STUCK_S`` (its ``sinceProgressS``
                       gauge): a dead new owner, exhausted credits, or
                       a wedged repair loop — see its /events journal
                       for the last ``rebalance_start``.
- ``index_stale``    — a node with the dedup/index plane on holds
                       peer-filter replicas far older than its
                       configured sync cadence: placement is
                       skipping ``has_chunks`` probes against a
                       membership summary that stopped refreshing —
                       the gossip loop is failing (see its
                       ``filter_sync_failures`` counter / journal).
- ``tier_stall``     — a node running the tiering plane with a
                       background scan cadence has made no tiering
                       progress for ``TIER_STALL_FACTOR`` scan
                       intervals (floored at ``TIER_STALL_MIN_S``):
                       the demotion worker is wedged or every scan is
                       erroring out — cold data silently stays at full
                       replication cost. Manual-scan nodes
                       (``scanIntervalS == 0``) are exempt: no cadence
                       was promised.
- ``hedge_storm``    — a node's hedged reads fired at (or beyond) the
                       hedge budget's refill rate for a sustained
                       window (``firedRecent``/``deniedRecent``,
                       the serve ``hedge`` stats' 60 s deques — the
                       shed_storm no-latch discipline): some replica
                       set is slow enough that nearly EVERY read wants
                       a hedge, i.e. the hedge plane is masking a sick
                       replica at steady cost instead of absorbing a
                       transient blip — find the slow peer (the
                       slow_peer rule usually names it) rather than
                       raising the budget.

Thresholds live here as module constants, dfs_tpu's values;
``chip_smoke.py``'s ``cluster_chaos`` phase checks that ``slow_peer``
names the node it made slow.
"""

from __future__ import annotations

SLOW_PEER_FACTOR = 3.0     # x median of the other peers
SLOW_PEER_FLOOR_S = 0.050  # absolute mean-latency floor
CLOCK_SKEW_S = 2.0
CACHE_MIN_LOOKUPS = 1024   # judge thrash only with real traffic
CACHE_HIT_FLOOR = 0.5
CREDIT_STALL_MIN_S = 1.0
CAPACITY_ETA_WARN_S = 24 * 3600.0   # disk full within a day: warning
CAPACITY_ETA_CRIT_S = 3600.0        # within the hour: critical
REBALANCE_STUCK_S = 120.0  # migrating with no progress this long =
                        # rebalance_stuck (a healthy rebalance makes
                        # progress every repair cycle; credits stretch
                        # a cycle, they do not zero its progress)
INDEX_STALE_FACTOR = 10.0  # x the node's configured filter_sync_s
INDEX_STALE_MIN_S = 60.0   # absolute floor, so a sub-second sync
                        # cadence does not page on one missed round
TIER_STALL_FACTOR = 5.0    # x the node's configured scan interval
TIER_STALL_MIN_S = 120.0   # absolute floor, so a sub-second test
                        # cadence does not page on one slow scan
HEDGE_STORM_MIN_FIRED = 8  # windowed-fired floor: a handful of hedges
                        # in a minute is the plane working, not a storm
HEDGE_STORM_WINDOW_S = 60.0  # the serve hedge stats' recency window
                        # (HedgePolicy.RECENT_WINDOW_S)
CENSUS_STALE_S = 900.0  # census findings older than this stop firing
                        # the underreplication rule: the census is
                        # pull-only, so a days-old snapshot must not
                        # latch a healed cluster critical forever (the
                        # shed_storm/loop_lag no-latch discipline);
                        # the LIVE repair queue keeps firing regardless


def _median(xs: list[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    if n == 0:
        return 0.0
    mid = n // 2
    return xs[mid] if n % 2 else (xs[mid - 1] + xs[mid]) / 2.0


def _rpc_means(snapshots: dict) -> dict[int, tuple[float, int]]:
    """peer id -> (mean seconds per call, calls) aggregated over every
    reporting node's client RPC table — every node's view of how slow
    each peer answers, combined. WINDOWED when available
    (``recentSeconds``/``recentCount``, RpcStats.RECENT_WINDOW_S): a
    peer that spent an hour dead accumulates connect-timeout seconds in
    the lifetime table and would read "slow" forever after recovering —
    the same no-latching rationale as shed_storm/loop_lag. Lifetime
    totals are the old-build fallback."""
    seconds: dict[int, float] = {}
    calls: dict[int, int] = {}
    for snap in snapshots.values():
        if not snap:
            continue
        for key, row in (snap.get("rpcClient") or {}).items():
            if not isinstance(key, str) or not isinstance(row, dict):
                continue   # malformed wire row: skip, don't lose the rule
            peer, _, _op = key.partition(":")
            try:
                pid = int(peer)
            except ValueError:
                continue   # _overflow fold or non-numeric label
            if "recentCount" in row:
                seconds[pid] = seconds.get(pid, 0.0) \
                    + row.get("recentSeconds", 0.0)
                calls[pid] = calls.get(pid, 0) + row.get("recentCount", 0)
            else:
                seconds[pid] = seconds.get(pid, 0.0) \
                    + row.get("seconds", 0.0)
                calls[pid] = calls.get(pid, 0) + row.get("count", 0)
    return {pid: (seconds[pid] / calls[pid], calls[pid])
            for pid in seconds if calls.get(pid)}


def diagnose(snapshots: dict[int, dict | None],
             coordinator_now: float) -> list[dict]:
    """Run the rule table over per-node snapshots (None = the peer did
    not answer). Returns findings, most severe first; an empty list is
    a healthy report, not a failure to look.

    Every rule runs FAULT-ISOLATED: snapshot fields come over the wire
    from peers that may run a different build (or be the very thing
    that is broken), so a malformed field must cost at most the rule it
    confuses — never the report. A crashed rule keeps whatever findings
    it appended and adds a visible ``doctor_error`` note naming the
    rule; it is never swallowed silently."""
    findings: list[dict] = []
    live = {nid: s for nid, s in snapshots.items()
            if isinstance(s, dict)}

    def dead_peer() -> None:
        # no snapshot, or any live node's health registry says so
        dead = sorted(nid for nid, s in snapshots.items()
                      if not isinstance(s, dict))
        reported_dead: dict[int, list[int]] = {}
        for nid, snap in live.items():
            for peer, alive in (snap.get("peersAlive") or {}).items():
                if alive:
                    continue
                try:
                    reported_dead.setdefault(int(peer), []).append(nid)
                except (TypeError, ValueError):
                    continue   # malformed registry key: skip, keep the
                    # rule — dead_peer is the one finding the doctor
                    # must never lose
        for nid in sorted(set(dead) | set(reported_dead)):
            ev = []
            if nid in dead:
                ev.append("no answer to the doctor probe")
            if nid in reported_dead:
                ev.append("reported dead by node(s) "
                          f"{sorted(reported_dead[nid])}")
            findings.append({"rule": "dead_peer", "severity": "critical",
                             "peers": [nid], "evidence": "; ".join(ev)})

    def slow_peer() -> None:
        # relative to the median of the OTHER peers
        means = _rpc_means(live)
        for pid in sorted(means):
            mean, n = means[pid]
            others = [m for q, (m, _) in means.items() if q != pid]
            if not others:
                continue
            base = _median(others)
            if mean >= SLOW_PEER_FLOOR_S \
                    and mean > SLOW_PEER_FACTOR * base:
                findings.append({
                    "rule": "slow_peer", "severity": "warning",
                    "peers": [pid],
                    "evidence": f"mean RPC {mean * 1000:.1f}ms over {n} "
                                f"calls vs {base * 1000:.1f}ms median of "
                                "the other peers"})

    def shed_storm() -> None:
        # windowed: "shed" is a since-boot counter, so diagnosing on it
        # would latch this finding red forever after one transient
        # overload (the doctor CLI gates health scripts on exit code).
        # "shedRecent" covers the gate's last ~60s; an old-build peer
        # without the windowed gauge falls back to the lifetime total —
        # latching beats losing the rule cross-version.
        shedders = []
        total_shed = 0
        for nid, snap in sorted(live.items()):
            shed = sum(g.get("shedRecent", g.get("shed", 0))
                       for g in (snap.get("admission") or {}).values()
                       if isinstance(g, dict))
            if shed:
                shedders.append(nid)
                total_shed += shed
        if shedders:
            findings.append({"rule": "shed_storm", "severity": "warning",
                             "peers": shedders,
                             "evidence": f"{total_shed} requests shed "
                                         f"(503) recently by node(s) "
                                         f"{shedders}"})

    def credit_starvation() -> None:
        for nid, snap in sorted(live.items()):
            credit = (snap.get("ingestStalls") or {}).get("creditS", 0.0)
            if credit >= CREDIT_STALL_MIN_S:
                findings.append({
                    "rule": "credit_starvation", "severity": "warning",
                    "peers": [nid],
                    "evidence": f"chunking blocked {credit:.1f}s on byte "
                                "credits (placement is the bottleneck)"})

    def cache_thrash() -> None:
        for nid, snap in sorted(live.items()):
            c = snap.get("cache") or {}
            if not c.get("enabled"):
                continue
            lookups = c.get("hits", 0) + c.get("misses", 0)
            if lookups < CACHE_MIN_LOOKUPS:
                continue
            rate = c.get("hits", 0) / lookups
            if rate < CACHE_HIT_FLOOR and c.get("evictions", 0) \
                    > c.get("inserts", 1) * 0.5:
                findings.append({
                    "rule": "cache_thrash", "severity": "warning",
                    "peers": [nid],
                    "evidence": f"hit rate {rate:.0%} over {lookups} "
                                f"lookups with {c['evictions']} "
                                "evictions (budget below the working "
                                "set)"})

    def clock_skew() -> None:
        # each snapshot's capture-time "now" vs the moment the
        # coordinator RECEIVED that snapshot (stamped per-response in
        # doctor_report), so a hung peer stalling the fan-out cannot
        # make every fast answer look skewed. coordinator_now is only
        # the fallback for snapshots without a receive stamp
        # (unit-built dicts). Rough: RTT not subtracted — the threshold
        # absorbs it.
        for nid, snap in sorted(live.items()):
            now = snap.get("now")
            if now is None:
                continue
            skew = now - snap.get("receivedAt", coordinator_now)
            if abs(skew) > CLOCK_SKEW_S:
                findings.append({
                    "rule": "clock_skew", "severity": "warning",
                    "peers": [nid],
                    "evidence": f"clock {skew:+.1f}s vs coordinator "
                                "(LWW tombstone ordering rides wall "
                                "clocks)"})

    def config_drift() -> None:
        hashes: dict[str, list[int]] = {}
        for nid, snap in sorted(live.items()):
            h = snap.get("configHash")
            if h:
                hashes.setdefault(str(h), []).append(nid)
        if len(hashes) > 1:
            groups = "; ".join(f"{h[:12]}…: nodes {nids}"
                               for h, nids in sorted(hashes.items()))
            findings.append({"rule": "config_drift",
                             "severity": "warning",
                             "peers": sorted(n for ns in hashes.values()
                                             for n in ns),
                             "evidence": "distinct config fingerprints "
                                         f"— {groups}"})

    def loop_lag() -> None:
        # windowed sentinel evidence: maxLagS is a lifetime max, so one
        # historical spike would latch this finding forever (same
        # rationale as shed_storm); recentMaxLagS covers the sentinel's
        # RECENT_WINDOW_S, with the lifetime max as the old-build
        # fallback.
        for nid, snap in sorted(live.items()):
            sent = snap.get("sentinel") or {}
            if not sent.get("enabled"):
                continue
            lag = sent.get("recentMaxLagS", sent.get("maxLagS", 0.0))
            if lag >= sent.get("lagThresholdS", float("inf")):
                findings.append({
                    "rule": "loop_lag", "severity": "warning",
                    "peers": [nid],
                    "evidence": "recent event-loop lag up to "
                                f"{lag:.3f}s"
                                f" ({sent.get('incidents', 0)} incidents"
                                " since boot — see its /events journal)"})

    def capacity_trend() -> None:
        # trend-aware disk-full ETA: free bytes / CAS growth slope
        # (history-sampler material — quiet when sampling is off or the
        # store is shrinking/steady). The slope is an over-the-window
        # average, so a one-burst upload decays out of the estimate as
        # the fine ring advances (no latching).
        for nid, snap in sorted(live.items()):
            cap = snap.get("capacity") or {}
            growth = cap.get("growthBytesPerS")
            free = (snap.get("disk") or {}).get("freeBytes")
            if not isinstance(growth, (int, float)) or growth <= 0 \
                    or not isinstance(free, (int, float)):
                continue
            eta = free / growth
            if eta <= CAPACITY_ETA_WARN_S:
                findings.append({
                    "rule": "capacity_trend",
                    "severity": "critical" if eta <= CAPACITY_ETA_CRIT_S
                    else "warning",
                    "peers": [nid],
                    "evidence": f"disk full in ~{eta / 3600:.1f}h at the "
                                f"current CAS growth rate "
                                f"({growth / 2**20:.2f} MiB/s, "
                                f"{free / 2**30:.2f} GiB free)"})

    def underreplication() -> None:
        # durability red line: the node's live repair queue, or the
        # last census this node coordinated, says digests sit below
        # their replication factor. Critical — every other finding is
        # about speed; this one is about data loss exposure.
        for nid, snap in sorted(live.items()):
            queue = snap.get("underReplicated") or 0
            census = snap.get("census") or {}
            seen = 0
            if isinstance(census, dict):
                # freshness gate against the SAME node's clock (its
                # census stamp vs its snapshot capture time — no
                # cross-node skew in the comparison)
                at, now = census.get("at"), snap.get("now")
                if isinstance(at, (int, float)) \
                        and isinstance(now, (int, float)) \
                        and now - at <= CENSUS_STALE_S:
                    seen = census.get("underReplicated") or 0
            if not isinstance(queue, int):
                queue = 0
            if not isinstance(seen, int):
                seen = 0
            if queue or seen:
                findings.append({
                    "rule": "underreplication", "severity": "critical",
                    "peers": [nid],
                    "evidence": f"{max(queue, seen)} digest(s) below "
                                f"replication factor (repair queue "
                                f"{queue}; last census {seen})"})

    def epoch_mismatch() -> None:
        # membership convergence: every node should place by the same
        # ring epoch. The gossip heals transient splits on first
        # contact, so a mismatch that survives long enough to be SEEN
        # by a doctor query is worth a name.
        epochs: dict[int, list[int]] = {}
        for nid, snap in sorted(live.items()):
            e = (snap.get("ring") or {}).get("epoch")
            if isinstance(e, int) and not isinstance(e, bool):
                epochs.setdefault(e, []).append(nid)
        if len(epochs) > 1:
            groups = "; ".join(f"epoch {e}: nodes {nids}"
                               for e, nids in sorted(epochs.items()))
            stale = [n for e, ns in sorted(epochs.items())[:-1]
                     for n in ns]
            findings.append({"rule": "epoch_mismatch",
                             "severity": "warning", "peers": stale,
                             "evidence": "split ring epoch view — "
                                         f"{groups} (stale nodes place "
                                         "by an old owner map)"})

    def rebalance_stuck() -> None:
        for nid, snap in sorted(live.items()):
            ring = snap.get("ring") or {}
            since = ring.get("sinceProgressS")
            if ring.get("migrating") \
                    and isinstance(since, (int, float)) \
                    and since >= REBALANCE_STUCK_S:
                findings.append({
                    "rule": "rebalance_stuck", "severity": "warning",
                    "peers": [nid],
                    "evidence": f"migrating to ring epoch "
                                f"{ring.get('epoch', '?')} with no "
                                f"movement progress for {since:.0f}s "
                                f"({ring.get('bytesMoved', 0)} bytes "
                                "moved so far — see its /events "
                                "journal)"})

    def index_stale() -> None:
        # probe-skipping placement is only as honest as its filter
        # replicas are fresh: a replica that stopped refreshing means
        # every "definitely absent" verdict is aging toward wrong
        for nid, snap in sorted(live.items()):
            ix = snap.get("index") or {}
            if not ix.get("enabled"):
                continue
            sync_s = ix.get("syncS")
            if not isinstance(sync_s, (int, float)) or sync_s <= 0:
                continue   # exchange off: nothing to be stale
            thresh = max(INDEX_STALE_MIN_S, INDEX_STALE_FACTOR * sync_s)
            stale = {p: age for p, age in (ix.get("peerAgeS")
                                           or {}).items()
                     if isinstance(age, (int, float)) and age >= thresh}
            if stale:
                worst = max(stale.values())
                findings.append({
                    "rule": "index_stale", "severity": "warning",
                    "peers": [nid],
                    "evidence": f"peer-filter replica(s) of node(s) "
                                f"{sorted(stale)} up to {worst:.0f}s "
                                f"old (sync cadence {sync_s:g}s) — "
                                "probe-skipping placement is trusting "
                                "a summary that stopped refreshing"})

    def tier_stall() -> None:
        # a tiering worker that stopped finishing scans fails QUIET:
        # reads still work (hot files replicated, cold files decode),
        # only the storage bill stops shrinking — exactly the kind of
        # silence the doctor exists to name
        for nid, snap in sorted(live.items()):
            t = snap.get("tier") or {}
            if not t.get("enabled"):
                continue
            interval = t.get("scanIntervalS")
            since = t.get("sinceProgressS")
            if not isinstance(interval, (int, float)) or interval <= 0:
                continue   # manual-scan node: no cadence promised
            if not isinstance(since, (int, float)):
                continue
            thresh = max(TIER_STALL_MIN_S, TIER_STALL_FACTOR * interval)
            if since >= thresh:
                findings.append({
                    "rule": "tier_stall", "severity": "warning",
                    "peers": [nid],
                    "evidence": f"no tiering progress for {since:.0f}s "
                                f"(scan cadence {interval:g}s, "
                                f"{t.get('errors', 0)} tier errors, "
                                f"{t.get('scans', 0)} scans done) — "
                                "cold data is staying at full "
                                "replication cost; see its /events "
                                "journal for tier_error"})

    def hedge_storm() -> None:
        # sustained hedging at the budget's refill rate: fired count
        # over the window reaches what the refill could possibly grant
        # — or hedges are being DENIED repeatedly (demand past the
        # budget). Either way the hedge plane is doing steady work,
        # which means a replica is persistently slow, not transiently
        # blipping. Both clauses carry the MIN floor: one blip that
        # wanted burst+1 hedges yields a single denial, and that is
        # the plane absorbing it as designed, not a storm.
        for nid, snap in sorted(live.items()):
            h = snap.get("hedge") or {}
            if not h.get("enabled"):
                continue
            refill = h.get("budgetPerS")
            fired = h.get("firedRecent", 0)
            denied = h.get("deniedRecent", 0)
            if not isinstance(refill, (int, float)) or refill <= 0 \
                    or not isinstance(fired, int) \
                    or not isinstance(denied, int):
                continue
            # the at-refill-rate bar, clamped to what the producer's
            # bounded window can actually count (hedge.py windowCap —
            # a saturated window IS a storm): without the clamp the
            # bar is unreachable for budgets above windowCap/60 per
            # second and the rule is dead code exactly for generous
            # budgets. Absent cap (old build) = unclamped fallback.
            bar = refill * HEDGE_STORM_WINDOW_S
            cap = h.get("windowCap")
            if isinstance(cap, int) and cap > 0:
                bar = min(bar, cap)
            if denied >= HEDGE_STORM_MIN_FIRED \
                    or (fired >= HEDGE_STORM_MIN_FIRED
                        and fired >= bar):
                findings.append({
                    "rule": "hedge_storm", "severity": "warning",
                    "peers": [nid],
                    "evidence": f"{fired} hedged read(s) fired"
                                + (f" and {denied} denied" if denied
                                   else "")
                                + f" in the last "
                                  f"{HEDGE_STORM_WINDOW_S:.0f}s against "
                                  f"a {refill:g}/s hedge budget — a "
                                  "replica is persistently slow (see "
                                  "slow_peer), the hedge plane is "
                                  "masking it at steady cost"})

    for rule in (dead_peer, slow_peer, shed_storm, credit_starvation,
                 cache_thrash, clock_skew, config_drift, loop_lag,
                 capacity_trend, underreplication, epoch_mismatch,
                 rebalance_stuck, index_stale, tier_stall,
                 hedge_storm):
        try:
            rule()
        except Exception as e:   # noqa: BLE001 — see docstring
            findings.append({
                "rule": "doctor_error", "severity": "info", "peers": [],
                "evidence": f"rule {rule.__name__} crashed on malformed "
                            f"snapshot data ({e!r}) — findings above "
                            "from it may be partial"})

    order = {"critical": 0, "warning": 1, "info": 2}
    findings.sort(key=lambda f: (order.get(f["severity"], 9), f["rule"]))
    return findings


def render_report(report: dict) -> str:
    """Plain-text doctor report for the ``doctor`` CLI subcommand."""
    nodes = report.get("nodes") or {}
    lines = [f"cluster doctor — {len(nodes)} node(s) queried, "
             f"{report.get('peersFailed', 0)} unreachable"]
    for nid in sorted(nodes, key=int):
        snap = nodes[nid]
        if not snap:
            lines.append(f"  node {nid}: NO ANSWER")
            continue
        disk = snap.get("disk") or {}
        free = disk.get("freeBytes")
        sent = snap.get("sentinel") or {}
        inc = len(snap.get("incidents") or [])
        lines.append(
            f"  node {nid}: chunks={snap.get('chunks', '?')} "
            f"files={snap.get('files', '?')} "
            + (f"diskFree={free / 2**30:.1f}GiB " if free is not None
               else "")
            + f"maxLag={sent.get('maxLagS', 0.0):.3f}s "
            f"incidents={inc} cfg={str(snap.get('configHash', ''))[:12]}")
    findings = report.get("findings") or []
    if not findings:
        lines.append("no pathology detected")
    for f in findings:
        lines.append(f"! [{f['severity']}] {f['rule']} "
                     f"(node(s) {f['peers']}): {f['evidence']}")
    return "\n".join(lines)


__all__ = ["diagnose", "render_report"]
