"""OpenMetrics text exposition for ``GET /metrics?format=prom`` (a copy
of dfs_tpu's ``obs/prom.py``: the same families and labels).

Served as ``application/openmetrics-text`` (not classic
``text/plain; version=0.0.4``) because the histogram bucket lines carry
exemplar suffixes — syntax that exists only in OpenMetrics; a classic
0.0.4 parser would reject the whole scrape on the first exemplar.
Prometheus picks its parser off the response Content-Type, so stock
scrapers handle the page (exemplars included) with no configuration.
OpenMetrics obligations honored here: counter ``# TYPE`` lines name the
family WITHOUT the ``_total`` suffix (samples keep it), every family's
samples are contiguous under its metadata, and the page ends ``# EOF``.

Flattens every metric registry the node owns into one scrapeable page:

- ``Counters``            -> ``dfs_counter_total{name=…}``
- ``Stopwatches``         -> ``dfs_stopwatch_seconds_total{name=…}`` and
                             ``dfs_peak{name=…}`` (gauges) for ``…Peak``
- ``LatencyRecorder``     -> ``dfs_latency_seconds`` HISTOGRAM series —
  the real log2 buckets (``_bucket{le=…}`` cumulative counts, ``_sum``,
  ``_count``), not the precomputed quantiles: Prometheus computes
  quantiles server-side and can aggregate histograms across nodes,
  which pre-digested p50/p90/p99 cannot do.
- ``RpcStats``            -> ``dfs_rpc_{client,server}_*_total{peer=…,op=…}``
  per-peer per-op calls/errors/retries/bytes/seconds.
- node gauges             -> ``dfs_under_replicated``, ``dfs_trace_spans``.

Label values are escaped per the exposition format (backslash, quote,
newline). The JSON ``/metrics`` endpoint is unchanged — this is an
additive, lossless view over the same registries.
"""

from __future__ import annotations

from dfs_tpu_torch.utils.trace import BUCKET_BOUNDS


def _esc(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v: float) -> str:
    """Float formatting: integral values without the trailing .0 noise,
    everything else shortest-round-trip repr."""
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _exemplar(ex: tuple[str, float, float] | None) -> str:
    """OpenMetrics exemplar suffix for a histogram bucket line —
    `` # {trace_id="…"} <observed seconds> <unix ts>`` — linking the
    bucket to the last trace that landed in it (absent when no traced
    observation ever did). Legal syntax ONLY because the page is served
    with the OpenMetrics content type (see module docstring)."""
    if ex is None:
        return ""
    tid, val, ts = ex
    return (f' # {{trace_id="{_esc(tid)}"}} {_fmt(float(val))}'
            f' {_fmt(round(float(ts), 3))}')


def render_node_metrics(node) -> str:
    """One node's full Prometheus page. ``node`` is the
    StorageNodeServer (duck-typed: counters / ingest_stalls / latency /
    obs / under_replicated)."""
    lines: list[str] = []

    def fam(name: str, mtype: str) -> None:
        # OpenMetrics metadata names the FAMILY; counter samples carry
        # _total ON TOP of it, so the TYPE line must not include the
        # suffix (a strict OM parser reading "# TYPE foo_total counter"
        # would demand samples named foo_total_total).
        if mtype == "counter" and name.endswith("_total"):
            name = name[: -len("_total")]
        lines.append(f"# TYPE {name} {mtype}")

    counters = node.counters.snapshot()
    fam("dfs_counter_total", "counter")
    for k in sorted(counters):
        lines.append(f'dfs_counter_total{{name="{_esc(k)}"}} {counters[k]}')

    sw = node.ingest_stalls.snapshot()
    accum = {k: v for k, v in sw.items() if not k.endswith("Peak")}
    peaks = {k: v for k, v in sw.items() if k.endswith("Peak")}
    if accum:
        fam("dfs_stopwatch_seconds_total", "counter")
        for k in sorted(accum):
            lines.append(f'dfs_stopwatch_seconds_total'
                         f'{{name="{_esc(k)}"}} {_fmt(accum[k])}')
    if peaks:
        fam("dfs_peak", "gauge")
        for k in sorted(peaks):
            lines.append(f'dfs_peak{{name="{_esc(k)}"}} {_fmt(peaks[k])}')

    hists = node.latency.histogram_snapshot()
    exemplars = node.latency.exemplar_snapshot()
    if hists:
        fam("dfs_latency_seconds", "histogram")
        for name in sorted(hists):
            buckets, count, total = hists[name]
            ex = exemplars.get(name, {})
            lbl = f'name="{_esc(name)}"'
            acc = 0
            for i, (bound, c) in enumerate(zip(BUCKET_BOUNDS, buckets)):
                acc += c
                lines.append(f'dfs_latency_seconds_bucket'
                             f'{{{lbl},le="{repr(bound)}"}} {acc}'
                             + _exemplar(ex.get(i)))
            # overflow bucket folds into +Inf; its cumulative count must
            # equal _count by construction
            acc += buckets[len(BUCKET_BOUNDS)]
            lines.append(f'dfs_latency_seconds_bucket'
                         f'{{{lbl},le="+Inf"}} {acc}'
                         + _exemplar(ex.get(len(BUCKET_BOUNDS))))
            lines.append(f'dfs_latency_seconds_sum{{{lbl}}} {_fmt(total)}')
            lines.append(f'dfs_latency_seconds_count{{{lbl}}} {count}')

    for side, stats in (("client", node.obs.rpc_client),
                        ("server", node.obs.rpc_server)):
        rows = stats.rows()
        if not rows:
            continue
        base = f"dfs_rpc_{side}"
        # one family at a time: the exposition format requires every
        # sample of a family contiguous under its single # TYPE line
        # (strict parsers reject interleaved families; Prometheus's
        # scraper merely tolerates them)
        for suffix, idx in (("ops_total", 0), ("errors_total", 1),
                            ("retries_total", 2)):
            fam(f"{base}_{suffix}", "counter")
            for peer, op, row in rows:
                lines.append(f'{base}_{suffix}{{peer="{_esc(peer)}"'
                             f',op="{_esc(op)}"}} {row[idx]}')
        fam(f"{base}_seconds_total", "counter")
        for peer, op, row in rows:
            lines.append(f'{base}_seconds_total{{peer="{_esc(peer)}"'
                         f',op="{_esc(op)}"}} {_fmt(row[5])}')
        fam(f"{base}_bytes_total", "counter")
        for peer, op, row in rows:
            lbl = f'peer="{_esc(peer)}",op="{_esc(op)}"'
            lines.append(f'{base}_bytes_total'
                         f'{{{lbl},direction="out"}} {row[3]}')
            lines.append(f'{base}_bytes_total'
                         f'{{{lbl},direction="in"}} {row[4]}')

    fam("dfs_under_replicated", "gauge")
    lines.append(f"dfs_under_replicated {len(node.under_replicated)}")
    obs = node.obs.stats()
    fam("dfs_trace_spans", "gauge")
    lines.append(f'dfs_trace_spans {obs["spans"]}')
    fam("dfs_trace_ring_capacity", "gauge")
    lines.append(f'dfs_trace_ring_capacity {obs["traceRing"]}')
    fam("dfs_trace_tail_spans", "gauge")
    lines.append(f'dfs_trace_tail_spans {obs["tailSpans"]}')
    journal = obs.get("journal") or {}
    if journal.get("enabled"):
        fam("dfs_journal_events_total", "counter")
        lines.append(f'dfs_journal_events_total {journal["emitted"]}')
        fam("dfs_journal_dropped_total", "counter")
        lines.append(f'dfs_journal_dropped_total {journal["dropped"]}')
    sentinel = obs.get("sentinel") or {}
    if sentinel.get("enabled"):
        fam("dfs_sentinel_incidents_total", "counter")
        lines.append(
            f'dfs_sentinel_incidents_total {sentinel["incidents"]}')
        fam("dfs_loop_lag_seconds", "gauge")
        lines.append(
            f'dfs_loop_lag_seconds {_fmt(sentinel["lastLagS"])}')
    # census/capacity plane: last-sampled gauges from the history
    # ring — never a store scan on the scrape path. getattr-guarded:
    # standalone tools and test fakes render without a census plane.
    census_stats = getattr(node, "census_stats", None)
    if census_stats is not None:
        cs = census_stats()
        cap = cs.get("capacity") or {}
        if cap.get("enabled"):
            for key, fam_name in (("casBytes", "dfs_cas_bytes"),
                                  ("casChunks", "dfs_cas_chunks"),
                                  ("diskFreeBytes",
                                   "dfs_disk_free_bytes"),
                                  ("diskTotalBytes",
                                   "dfs_disk_total_bytes")):
                v = cap.get(key)
                if isinstance(v, (int, float)):
                    fam(fam_name, "gauge")
                    lines.append(f"{fam_name} {_fmt(v)}")
        last = cs.get("lastCensus") or {}
        if last:
            fam("dfs_census_under_replicated", "gauge")
            lines.append(f"dfs_census_under_replicated "
                         f"{last.get('underReplicated', 0)}")
            fam("dfs_census_orphaned", "gauge")
            lines.append(f"dfs_census_orphaned "
                         f"{last.get('orphaned', 0)}")
    # dedup/index plane: LSI + filter gauges and the probe-skip
    # counters — present only when the plane is on (additive, like the
    # census block above). getattr-guarded for standalone/test fakes.
    index_stats = getattr(node, "index_stats", None)
    if index_stats is not None:
        ix = index_stats()
        lsi = ix.get("lsi")
        if lsi:
            for key, fam_name in (
                    ("memtableBytes", "dfs_index_memtable_bytes"),
                    ("runCount", "dfs_index_runs"),
                    ("runEntries", "dfs_index_run_entries")):
                fam(fam_name, "gauge")
                lines.append(f"{fam_name} {lsi.get(key, 0)}")
            fam("dfs_index_compactions_total", "counter")
            lines.append(f"dfs_index_compactions_total "
                         f"{lsi.get('compactions', 0)}")
            fam("dfs_index_rebuilds_total", "counter")
            lines.append(f"dfs_index_rebuilds_total "
                         f"{lsi.get('rebuilds', 0)}")
        if "probesSkipped" in ix:
            fam("dfs_index_filter_bytes", "gauge")
            lines.append(f"dfs_index_filter_bytes "
                         f"{(ix.get('filter') or {}).get('bytes', 0)}")
            for key, fam_name in (
                    ("probesSkipped", "dfs_index_probes_skipped"),
                    ("probeRpcsSkipped",
                     "dfs_index_probe_rpcs_skipped"),
                    ("filterTrusted", "dfs_index_filter_trusted"),
                    ("filterFp", "dfs_index_filter_fp")):
                fam(f"{fam_name}_total", "counter")
                lines.append(f"{fam_name}_total {ix.get(key, 0)}")
    # hot/cold tiering plane: demotion/promotion progress and the
    # bytes the cold tier reclaimed — present only when the plane is on
    # (additive, like the census/index blocks). getattr-guarded for
    # standalone/test fakes.
    tier_stats = getattr(node, "tier_stats", None)
    if tier_stats is not None:
        ts = tier_stats()
        if ts.get("enabled"):
            for key, fam_name in (
                    ("ledgerSize", "dfs_tier_ledger_entries"),
                    ("sinceProgressS", "dfs_tier_since_progress_seconds"),
                    ("creditStallS", "dfs_tier_credit_stall_seconds")):
                fam(fam_name, "gauge")
                lines.append(f"{fam_name} {_fmt(ts.get(key, 0))}")
            for key, fam_name in (
                    ("scans", "dfs_tier_scans"),
                    ("demotedFiles", "dfs_tier_demoted_files"),
                    ("demotedBytes", "dfs_tier_demoted_bytes"),
                    ("parityBytes", "dfs_tier_parity_bytes"),
                    ("reclaimedBytes", "dfs_tier_reclaimed_bytes"),
                    ("promotedFiles", "dfs_tier_promoted_files"),
                    ("promotedBytes", "dfs_tier_promoted_bytes"),
                    ("errors", "dfs_tier_errors")):
                fam(f"{fam_name}_total", "counter")
                lines.append(f"{fam_name}_total {ts.get(key, 0)}")
    lines.append("# EOF")   # OpenMetrics required terminator
    return "\n".join(lines) + "\n"
