"""Command line of the port: ``serve`` runs a storage node, the other
subcommands talk HTTP to one.

    python -m dfs_tpu_torch.cli.main serve --node-id 1 --nodes 5 \\
        --base-port 7101 --base-internal-port 7201 --data-root data
    python -m dfs_tpu_torch.cli.main --port 7101 upload f.bin
    python -m dfs_tpu_torch.cli.main --port 7101 upload --ec 3 f.bin
    python -m dfs_tpu_torch.cli.main serve --node-id 1 --sim ...   # deltas
    python -m dfs_tpu_torch.cli.main serve --node-id 1 \
        --cache-bytes 536870912 --readahead 2 --hedge-budget 50 ...
    python -m dfs_tpu_torch.cli.main serve --node-id 1 --index \\
        --tier --tier-ec-k 3 ...                    # index + tiering
    python -m dfs_tpu_torch.cli.main serve --node-id 1 --chaos \\
        --chaos-seed 13 ...                         # fault injection
    python -m dfs_tpu_torch.cli.main --port 7101 upload --trace f.bin
    python -m dfs_tpu_torch.cli.main --port 7102 trace <traceId>
    python -m dfs_tpu_torch.cli.main --port 7101 events --limit 20
    python -m dfs_tpu_torch.cli.main serve --node-id 1 --nodes 4 \
        --ring-vnodes 64 --ring-members 1,2,3 ...   # node 4 a standby
    python -m dfs_tpu_torch.cli.main --port 7101 ring add 4
    python -m dfs_tpu_torch.cli.main --port 7101 ring drain 4
    python -m dfs_tpu_torch.cli.main --port 7101 census   # also df, doctor
    python -m dfs_tpu_torch.cli.main --port 7101 upload --resume f.bin
    python -m dfs_tpu_torch.cli.main --port 7101 upload --smart f.bin
    python -m dfs_tpu_torch.cli.main --port 7102 download --smart <fileId>
    python -m dfs_tpu_torch.cli.main --port 7101 menu     # interactive
    python -m dfs_tpu_torch.cli.main sidecar --sidecar-port 50151
    python -m dfs_tpu_torch.cli.main serve --node-id 1 \
        --sidecar-port 50151 ...                    # chunking delegated

``serve`` runs the node's chunking on the CUDA card; without one it exits
non-zero unless ``--device cpu`` asks for the plain versions. So do
``upload --resume`` and ``upload --smart``, which chunk in the client's
own process; ``download --smart`` never chunks and needs no card.
``sidecar`` serves the chunking engine over gRPC (dfs_tpu's ``dfs.Sidecar``
contract). ``--fragmenter`` takes every name of dfs_tpu's: ``fixed``,
``cdc``, ``cdc-aligned`` and ``cdc-anchored`` are host strategies that run
no kernel; a ``-tpu`` name runs the port's ``-cuda`` engine on ``--device``.
Tracing, the journal and the sentinel are on by default (``--trace-ring 0
--journal-bytes 0 --sentinel-interval 0`` turns them off). Subcommands:
serve, sidecar, status, list, upload, download, delete, metrics, events,
trace, doctor, census, df, ring, menu.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from pathlib import Path

from dfs_tpu_torch.cli.client import NodeClient
from dfs_tpu_torch.config import (CDCParams, CensusConfig, ChaosConfig,
                                  ClusterConfig, DurabilityConfig,
                                  FragmenterConfig, IndexConfig,
                                  IngestConfig, NodeConfig, ObsConfig,
                                  RingConfig, ServeConfig, SimConfig,
                                  TierConfig)


def _client(args) -> NodeClient:
    return NodeClient(host=args.host, port=args.port,
                      timeout_s=args.timeout)


def _smart_client(args):
    """``--smart``: the SmartClient built from the ``--client-*`` knobs,
    chunking on ``--device``; it degrades to the coordinator path unless
    ``--client-no-fallback``."""
    from dfs_tpu_torch.client import SmartClient
    from dfs_tpu_torch.config import ClientConfig

    cfg = ClientConfig(
        window=args.client_window,
        stripe=args.client_stripe,
        hedge_budget_per_s=args.client_hedge_budget,
        hedge_floor_s=args.client_hedge_floor,
        hedge_cap_s=args.client_hedge_cap,
        filter_max_age_s=args.client_filter_max_age,
        echo_cache_entries=args.client_echo_cache,
        fallback=not args.client_no_fallback,
    )
    return SmartClient(host=args.host, port=args.port, cfg=cfg,
                       timeout_s=args.timeout, device=_client_device(args))


def _client_device(args):
    """Where a client subcommand chunks: None (the card) or "cpu"."""
    return None if getattr(args, "device", "cuda") == "cuda" else args.device


def _no_card(args, what: str) -> bool:
    """True, after printing the missing-card message, when ``what`` would
    chunk on a card that is not there."""
    from dfs_tpu_torch import resolve_device

    try:
        resolve_device(_client_device(args))
    except RuntimeError as e:
        print(f"{what}: {e}", file=sys.stderr)
        return True
    return False


def node_config(args) -> NodeConfig:
    """The NodeConfig ``serve`` runs with."""
    if args.cluster_config:
        cluster = ClusterConfig.from_file(args.cluster_config)
        if args.replication_factor is not None:
            print(f"warning: --replication-factor ignored; using "
                  f"{cluster.replication_factor} from "
                  f"{args.cluster_config}", file=sys.stderr)
    else:
        cluster = ClusterConfig.localhost(
            n_nodes=args.nodes, base_port=args.base_port,
            base_internal_port=args.base_internal_port,
            replication_factor=args.replication_factor
            if args.replication_factor is not None else 2)
    return NodeConfig(
        node_id=args.node_id, cluster=cluster,
        data_root=Path(args.data_root), fragmenter=args.fragmenter,
        sidecar_port=args.sidecar_port,
        cdc=CDCParams(min_size=args.min_chunk, avg_size=args.avg_chunk,
                      max_size=args.max_chunk),
        fixed_parts=args.fixed_parts,
        frag=FragmenterConfig(devices=args.cdc_devices,
                              region_bytes=args.cdc_region_bytes,
                              staging_buffers=args.cdc_staging_buffers),
        connect_timeout_s=args.connect_timeout,
        request_timeout_s=args.request_timeout,
        retries=args.rpc_retries,
        health_probe_s=args.probe_interval,
        write_quorum=args.write_quorum,
        serve=ServeConfig(cache_bytes=args.cache_bytes,
                          readahead_batches=args.readahead,
                          download_slots=args.download_slots,
                          upload_slots=args.upload_slots,
                          internal_slots=args.internal_slots,
                          queue_depth=args.queue_depth,
                          retry_after_s=args.retry_after,
                          default_deadline_s=args.default_deadline,
                          hedge_floor_s=args.hedge_floor,
                          hedge_cap_s=args.hedge_cap,
                          hedge_budget_per_s=args.hedge_budget),
        ingest=IngestConfig(window=args.ingest_window,
                            flush_bytes=args.ingest_flush_bytes,
                            credit_bytes=args.ingest_credit_bytes,
                            slice_inflight=args.replicate_inflight,
                            cas_io_threads=args.cas_io_threads),
        obs=ObsConfig(trace_ring=args.trace_ring,
                      slow_span_s=args.slow_span,
                      tail_keep=args.tail_keep,
                      journal_bytes=args.journal_bytes,
                      journal_segment_bytes=args.journal_segment_bytes,
                      sentinel_interval_s=args.sentinel_interval,
                      sentinel_lag_s=args.sentinel_lag),
        census=CensusConfig(
            history_interval_s=args.census_interval,
            history_slots=args.census_history_slots,
            history_coarse_every=args.census_coarse_every,
            history_coarse_slots=args.census_coarse_slots,
            max_listed=args.census_max_listed),
        durability=DurabilityConfig(mode=args.durability),
        ring=RingConfig(
            vnodes=args.ring_vnodes,
            members=args.ring_members,
            rebalance_credit_bytes=args.ring_rebalance_credit_bytes),
        chaos=ChaosConfig(
            enabled=args.chaos,
            seed=args.chaos_seed,
            rpc_delay_s=args.chaos_rpc_delay,
            rpc_delay_peers=args.chaos_rpc_delay_peers,
            rpc_drop_rate=args.chaos_rpc_drop_rate,
            partition=args.chaos_partition,
            rpc_truncate_rate=args.chaos_rpc_truncate_rate,
            serve_delay_s=args.chaos_serve_delay,
            disk_error_rate=args.chaos_disk_error_rate,
            disk_full=args.chaos_disk_full,
            disk_delay_s=args.chaos_disk_delay,
            crash_point=args.chaos_crash_point),
        device=None if args.device == "cuda" else args.device,
        sim=SimConfig(
            enabled=args.sim,
            sketch_size=args.sim_sketch_size,
            bands=args.sim_bands,
            shingle_bytes=args.sim_shingle_bytes,
            max_candidates=args.sim_max_candidates,
            min_chunk_bytes=args.sim_min_chunk_bytes,
            min_savings_frac=args.sim_min_savings_frac,
            max_delta_depth=args.sim_max_delta_depth,
            devices=args.sim_devices,
            rematerialize_reads=args.sim_rematerialize_reads),
        index=IndexConfig(
            enabled=args.index,
            memtable_entries=args.index_memtable_entries,
            compact_runs=args.index_compact_runs,
            filter_bits_per_key=args.index_filter_bits,
            filter_sync_s=args.index_filter_sync,
            background_compact=args.index_background_compact,
            echo_cache_entries=args.index_echo_cache),
        tier=TierConfig(
            enabled=args.tier,
            hot_fraction=args.tier_hot_fraction,
            min_idle_s=args.tier_min_idle,
            scan_interval_s=args.tier_scan_interval,
            ec_k=args.tier_ec_k,
            demote_credit_bytes=args.tier_demote_credit_bytes,
            half_life_s=args.tier_half_life,
            promote_reads=args.tier_promote_reads,
            redemote_cooldown_s=args.tier_redemote_cooldown,
            ledger_entries=args.tier_ledger_entries))


def cmd_serve(args) -> int:
    from dfs_tpu_torch.node.runtime import StorageNodeServer
    from dfs_tpu_torch.utils.aio import create_logged_task

    cfg = node_config(args)
    try:
        node = StorageNodeServer(cfg)
    except RuntimeError as e:        # no card (resolve_device's message)
        print(f"serve: {e}", file=sys.stderr)
        return 2
    except ValueError as e:          # an unregistered crash point
        print(f"serve: {e}", file=sys.stderr)
        return 1

    async def run() -> None:
        await node.start()
        tasks: list[asyncio.Task] = []   # strong refs to the loops

        def periodic(interval: float, what: str, fn) -> None:
            if interval <= 0:
                return

            async def loop() -> None:
                while True:
                    await asyncio.sleep(interval)
                    try:
                        await fn()
                    except Exception as e:  # noqa: BLE001
                        node.log.warning("%s failed: %s", what, e)

            tasks.append(create_logged_task(loop(), node.log, what))

        async def do_repair() -> None:
            n = await node.repair_once()
            if n:
                node.log.info("repair: re-replicated %d chunks", n)

        async def do_scrub() -> None:
            res = await node.scrub_once()
            if res["corrupt"]:
                node.log.warning("scrub: %d corrupt chunks evicted",
                                 res["corrupt"])

        periodic(args.repair_interval, "repair", do_repair)
        periodic(args.scrub_interval, "scrub", do_scrub)
        await asyncio.Event().wait()     # serve until killed

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


def cmd_sidecar(args) -> int:
    """Serve the chunking engine as the ``dfs.Sidecar`` gRPC service
    until SIGINT or SIGTERM (exit 0)."""
    import signal
    import threading

    from dfs_tpu_torch.sidecar import SidecarServer

    try:
        srv = SidecarServer(
            port=args.sidecar_port, fragmenter=args.fragmenter,
            cdc_params=CDCParams(min_size=args.min_chunk,
                                 avg_size=args.avg_chunk,
                                 max_size=args.max_chunk),
            device=None if args.device == "cuda" else args.device)
    except RuntimeError as e:        # no card (resolve_device's message)
        print(f"sidecar: {e}", file=sys.stderr)
        return 2
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    srv.start()
    print(f"sidecar listening on 127.0.0.1:{srv.port} "
          f"(fragmenter={srv.fragmenter.name})", flush=True)
    while not stop.wait(0.5):
        pass
    srv.stop()
    return 0


def cmd_status(args) -> int:
    print(_client(args).status())
    return 0


def cmd_list(args) -> int:
    files = _client(args).list_files()
    if not files:
        print("(no files)")
    for i, f in enumerate(files, 1):
        print(f"{i}. {f.name}  id={f.file_id[:16]}…  size={f.size}  "
              f"chunks={f.chunks}")
    return 0


def _maybe_trace_id(args) -> str | None:
    """--trace: a client-minted trace id every span of the request is
    tagged with; inspect it afterwards with ``trace <id>``."""
    if not getattr(args, "trace", False):
        return None
    from dfs_tpu_torch.obs import new_trace_id

    return new_trace_id()


def cmd_upload(args) -> int:
    path = Path(args.file)
    data = path.read_bytes()
    ec = getattr(args, "ec", 0)
    trace_id = _maybe_trace_id(args)
    if getattr(args, "smart", False):
        if ec or getattr(args, "resume", False):
            print("--smart is mutually exclusive with --ec/--resume "
                  "(the SDK has its own dedup probe; EC needs the "
                  "whole-body coordinator path)", file=sys.stderr)
            return 2
        if _no_card(args, "upload --smart"):
            return 2
        info = _smart_client(args).upload(data, name=path.name)
        print(f"Uploaded ({info['dataPlane']}): fileId={info['fileId']} "
              f"chunks={info['chunks']} "
              f"clientSent={info['clientBytesSent']}B of {len(data)}B")
        return 0
    if getattr(args, "resume", False):
        if ec:
            print("--ec and --resume are mutually exclusive "
                  "(parity stripes need the whole-body upload path)",
                  file=sys.stderr)
            return 2
        if _no_card(args, "upload --resume"):
            return 2
        # chunk here, ask what is missing, send only that
        info = _client(args).upload_resume(data, name=path.name,
                                           trace_id=trace_id,
                                           device=_client_device(args))
        tr = f" traceId={trace_id}" if trace_id else ""
        print(f"Uploaded (resume): fileId={info['fileId']} "
              f"chunks={info['chunks']} "
              f"clientSent={info['clientBytesSent']}B of {len(data)}B{tr}")
        return 0
    info = _client(args).upload(data, name=path.name, ec=ec,
                                trace_id=trace_id)
    extra = (f" ecParity={info['ecParityBytes']}B"
             if "ecParityBytes" in info else "")
    if trace_id:
        extra += f" traceId={trace_id}"
    print(f"Uploaded: fileId={info['fileId']} chunks={info['chunks']} "
          f"transferred={info.get('transferredBytes', '?')}B "
          f"dedupSkipped={info.get('dedupSkippedBytes', '?')}B{extra}")
    return 0


def cmd_download(args) -> int:
    c = _client(args)
    trace_id = _maybe_trace_id(args)
    if getattr(args, "smart", False):
        sc = _smart_client(args)
        data = sc.download(args.file_id)
        plane = "legacy" if sc.counters["legacyDownloads"] else "smart"
        print(f"dataPlane={plane}")
    else:
        data = c.download(args.file_id, trace_id=trace_id)
    if trace_id:
        print(f"traceId={trace_id}")
    name = args.file_id
    for f in c.list_files():
        if f.file_id == args.file_id:
            name = f.name
            break
    out = Path(args.out or "downloads") / name
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(data)
    print(f"Saved {len(data)} bytes to {out}")
    return 0


def cmd_delete(args) -> int:
    print(_client(args).delete(args.file_id))
    return 0


def cmd_metrics(args) -> int:
    if args.prom:
        print(_client(args).metrics_prom(), end="")
        return 0
    print(json.dumps(_client(args).metrics(), indent=2, sort_keys=True))
    return 0


def cmd_events(args) -> int:
    """One node's recent journal events (GET /events), one line each,
    oldest first."""
    import datetime

    data = _client(args).events(since=args.since, limit=args.limit)
    if not data.get("enabled", True):
        print("(journal disabled on this node)")
        return 0
    for ev in data.get("events", []):
        ts = datetime.datetime.fromtimestamp(
            ev.get("ts", 0.0)).strftime("%Y-%m-%d %H:%M:%S")
        rest = {k: v for k, v in ev.items()
                if k not in ("ts", "type", "node", "trace")}
        trace = f" trace={ev['trace']}" if ev.get("trace") else ""
        extra = " ".join(f"{k}={v}" for k, v in sorted(rest.items()))
        print(f"{ts} node={ev.get('node', '?')} {ev.get('type', '?')} "
              f"{extra}{trace}".rstrip())
    if data.get("dropped"):
        print(f"(warning: {data['dropped']} events dropped at the "
              "bounded writer)", file=sys.stderr)
    if data.get("torn"):
        print(f"(note: {data['torn']} torn/corrupt journal line(s) "
              "skipped)", file=sys.stderr)
    return 0


def cmd_trace(args) -> int:
    """Render one trace stitched across the cluster: the contacted node
    gathers every peer's spans, this prints the tree with a slow-span log
    on top."""
    from dfs_tpu_torch.obs.stitch import render_tree

    data = _client(args).trace(args.trace_id)
    slow = args.slow if args.slow is not None \
        else float(data.get("slowSpanS", 1.0))
    print(render_tree(data.get("spans", []), slow_s=slow))
    if data.get("peersFailed"):
        print(f"(warning: {data['peersFailed']} peer(s) unreachable — "
              "trace may be partial)", file=sys.stderr)
    return 0


def cmd_doctor(args) -> int:
    """Print the doctor's named pathologies with their evidence; exit 1
    on a warning or critical finding or an unreachable peer."""
    from dfs_tpu_torch.obs.doctor import render_report

    report = _client(args).doctor(cluster=not args.local)
    print(render_report(report))
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    sick = any(f.get("severity") in ("critical", "warning")
               for f in report.get("findings") or []) \
        or report.get("peersFailed", 0)
    return 1 if sick else 0


def cmd_census(args) -> int:
    """Print the replication census; exit 1 on findings or an
    unreachable peer."""
    from dfs_tpu_torch.obs.census import render_census

    report = _client(args).census(cluster=not args.local)
    print(render_census(report))
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    sick = any(report.get(f"{k}Total") for k in
               ("underReplicated", "orphaned", "overReplicated")) \
        or report.get("peersFailed", 0)
    return 1 if sick else 0


def cmd_df(args) -> int:
    """Print cluster capacity: per-node CAS bytes, disk headroom, dedup
    ratio (the capacity section of ``GET /census``)."""
    from dfs_tpu_torch.obs.census import render_df

    report = _client(args).census(cluster=True)
    print(render_df(report))
    if report.get("peersFailed"):
        print(f"(warning: {report['peersFailed']} peer(s) unreachable "
              "— totals are partial)", file=sys.stderr)
    return 0


def cmd_ring(args) -> int:
    """``ring status`` prints the epoch, members and migration view of the
    cluster (exit 1 on a split view or an unreachable peer); ``ring
    add/drain/remove/reweight <node>`` bumps the epoch on the contacted
    node, which pushes it to every peer."""
    c = _client(args)
    if args.action == "status":
        st = c.ring_status()
        mode = st.get("mode", "?")
        lines = [f"ring epoch {st.get('epoch')} ({mode}"
                 + (f", {st.get('vnodes')} vnodes" if mode == "hash"
                    else "") + ")"
                 + (" — MIGRATING from epoch "
                    f"{st.get('previousEpoch')}"
                    if st.get("migrating") else "")]
        for m in st.get("members", []):
            w = m.get("weight", 1.0)
            lines.append(f"  node {m.get('nodeId')}: weight {w}"
                         + ("  (draining)" if w == 0 else ""))
        reb = st.get("rebalance") or {}
        if reb.get("bytesMoved"):
            lines.append(f"  rebalance: {reb['bytesMoved']} bytes "
                         f"moved, {reb.get('pushes', 0)} pushes, "
                         f"creditStallS={reb.get('creditStallS', 0)}, "
                         f"dualReadHits={reb.get('dualReadHits', 0)}")
        for nid, p in sorted((st.get("peers") or {}).items(),
                             key=lambda kv: int(kv[0])):
            if p is None:
                lines.append(f"  peer {nid}: NO ANSWER")
            elif p.get("epoch") != st.get("epoch") or p.get("migrating"):
                lines.append(f"  peer {nid}: epoch {p.get('epoch')}"
                             + (" (migrating)" if p.get("migrating")
                                else ""))
        print("\n".join(lines))
        if st.get("peersFailed"):
            print(f"(warning: {st['peersFailed']} peer(s) unreachable "
                  "— view is partial)", file=sys.stderr)
        split = any(p is not None and p.get("epoch") != st.get("epoch")
                    for p in (st.get("peers") or {}).values())
        return 1 if split or st.get("peersFailed") else 0
    out = c.ring_admin(args.action, node_id=args.node,
                       weight=args.weight)
    print(f"ring epoch {out.get('epoch')} installed "
          f"({args.action} node {args.node}); pushed to: "
          + ", ".join(f"{k}={'ok' if v else 'FAILED'}"
                      for k, v in sorted(
                          (out.get('pushed') or {}).items(),
                          key=lambda kv: int(kv[0]))))
    return 0


def cmd_menu(args) -> int:
    """The interactive loop of dfs_tpu's client: 0 Exit, 1 Test server,
    2 List files, 3 Upload file, 4 Download file. An error in one choice
    is printed and the loop goes on; end of input exits 0."""
    while True:
        print("\n=== Distributed File Storage (CUDA) ===\n"
              "0. Exit\n1. Test server\n2. List files\n"
              "3. Upload file\n4. Download file")
        try:
            choice = input("> ").strip()
        except EOFError:
            return 0
        try:
            if choice == "0":
                return 0
            elif choice == "1":
                args.port = _ask_port(args.port)
                print(_client(args).status())
            elif choice == "2":
                args.port = _ask_port(args.port)
                cmd_list(args)
            elif choice == "3":
                args.port = _ask_port(args.port)
                directory = input("Directory [.]: ").strip() or "."
                files = sorted(p for p in Path(directory).iterdir()
                               if p.is_file())
                if not files:
                    print("(no files)")
                    continue
                for i, p in enumerate(files, 1):
                    print(f"{i}. {p.name} ({p.stat().st_size} bytes)")
                idx = int(input("File #: ")) - 1
                args.file = str(files[idx])
                cmd_upload(args)
            elif choice == "4":
                args.port = _ask_port(args.port)
                files = _client(args).list_files()
                for i, f in enumerate(files, 1):
                    print(f"{i}. {f.name}")
                if not files:
                    print("(no files)")
                    continue
                idx = int(input("File #: ")) - 1
                args.file_id = files[idx].file_id
                args.out = None
                cmd_download(args)
            else:
                print("Invalid option")
        except Exception as e:  # noqa: BLE001 - one choice's error
            print(f"Error: {e}")


def _ask_port(default: int) -> int:
    """The port prompt; empty or not a number keeps ``default``."""
    raw = input(f"Node port [{default}]: ").strip()
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


# dfs_tpu's names (a -tpu name gives the port's engine on the card, and
# manifests record its -cuda name), then the port's -cuda names
_FRAGMENTERS = ["auto", "fixed", "cdc", "cdc-tpu", "cdc-aligned",
                "cdc-aligned-tpu", "cdc-anchored", "cdc-anchored-tpu",
                "cdc-cuda", "cdc-aligned-cuda", "cdc-anchored-cuda"]
_FRAGMENTER_HELP = ("auto, cdc-anchored-cuda (-tpu): the anchored CDC + "
                    "SHA-256 chain on --device; cdc-aligned-cuda (-tpu): "
                    "aligned CDC v2 on --device; cdc-cuda (-tpu): the v1 "
                    "rolling pipeline on --device (deprecated); fixed, cdc, "
                    "cdc-aligned, cdc-anchored: host strategies")


def _add_client_flags(p, device: bool) -> None:
    """The ``--smart`` data plane's knobs (ClientConfig) and, where the
    command chunks (``upload``), ``--device``."""
    if device:
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="where upload --resume and --smart chunk: the "
                            "CUDA card (default; fails without one) or "
                            "the plain versions on the CPU")
    p.add_argument("--smart", action="store_true",
                   help="use the SDK data plane: chunk and hash here, "
                        "consult peer-existence filters, stripe straight "
                        "to the rf ring owners, one-call commit; falls "
                        "back to the coordinator path on old servers or "
                        "a refused commit")
    p.add_argument("--client-window", type=int, default=2,
                   help="store slices in flight per peer")
    p.add_argument("--client-stripe", type=int, default=4,
                   help="concurrent read batches across owners")
    p.add_argument("--client-hedge-budget", type=float, default=0.0,
                   help="hedged read budget (fires/s); 0 = no "
                        "client-side hedging")
    p.add_argument("--client-hedge-floor", type=float, default=0.05,
                   help="minimum hedge delay (s)")
    p.add_argument("--client-hedge-cap", type=float, default=1.0,
                   help="maximum hedge delay (s)")
    p.add_argument("--client-filter-max-age", type=float, default=30.0,
                   help="peer-existence filter freshness bound (s); "
                        "older replicas degrade to probes")
    p.add_argument("--client-echo-cache", type=int, default=4096,
                   help="echo-confirmed existence cache entries per peer "
                        "(0 = always run the trust probe)")
    p.add_argument("--client-no-fallback", action="store_true",
                   help="raise instead of degrading to the legacy "
                        "coordinator path")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dfs-tpu-torch",
        description="content-addressed distributed file storage, chunking "
                    "on an NVIDIA card")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=5001)
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="HTTP timeout of the client subcommands (s)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    serve = sub.add_parser("serve", help="run a storage node")
    serve.add_argument("--node-id", type=int, required=True)
    serve.add_argument("--cluster-config", default=None,
                       help="JSON/TOML cluster membership file (overrides "
                            "--nodes/--base-port/--replication-factor)")
    serve.add_argument("--nodes", type=int, default=5)
    serve.add_argument("--base-port", type=int, default=5001)
    serve.add_argument("--base-internal-port", type=int, default=6001)
    serve.add_argument("--replication-factor", type=int, default=None)
    serve.add_argument("--data-root", default="data")
    serve.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="where the chunking runs: the CUDA card "
                            "(default; fails without one) or the plain "
                            "versions on the CPU")
    serve.add_argument("--fragmenter", default="auto", choices=_FRAGMENTERS,
                       help=_FRAGMENTER_HELP)
    serve.add_argument("--cdc-devices", type=int, default=0,
                       help="shard 'cdc' / 'cdc-anchored' (and auto, "
                            "cdc-anchored-cuda) streaming regions over N "
                            "device slots (0/1 = single-device; boundaries "
                            "are byte-identical either way)")
    serve.add_argument("--cdc-region-bytes", type=int, default=0,
                       help="fixed device-region size for sharded CDC "
                            "(0 = devices * 1 MiB rolling / 64 MiB "
                            "anchored)")
    serve.add_argument("--cdc-staging-buffers", type=int, default=2,
                       help="window batches in flight in the batched walk")
    serve.add_argument("--min-chunk", type=int, default=2048)
    serve.add_argument("--avg-chunk", type=int, default=8192)
    serve.add_argument("--max-chunk", type=int, default=65536)
    serve.add_argument("--fixed-parts", type=int, default=5,
                       help="the fixed strategy's part count (reference "
                            "parity: TOTAL_NODES=5)")
    serve.add_argument("--connect-timeout", type=float, default=2.0,
                       help="per-attempt peer connect timeout (s)")
    serve.add_argument("--request-timeout", type=float, default=10.0,
                       help="per-attempt peer request timeout (s); bulk "
                            "transfers add a size-derived margin")
    serve.add_argument("--rpc-retries", type=int, default=3,
                       help="peer call attempts before a peer counts as "
                            "unreachable")
    serve.add_argument("--probe-interval", type=float, default=5.0,
                       help="seconds between peer health probes; 0 = "
                            "data-path feedback only")
    serve.add_argument("--write-quorum", type=int, default=2,
                       help="copies (the local one included) an upload "
                            "needs before it acknowledges")
    serve.add_argument("--retry-after", type=float, default=1.0,
                       help="Retry-After seconds advertised on 503 "
                            "shed responses")
    serve.add_argument("--repair-interval", type=float, default=30.0,
                       help="seconds between repair cycles; 0 disables")
    serve.add_argument("--scrub-interval", type=float, default=3600.0,
                       help="seconds between local integrity sweeps; 0 "
                            "disables")
    serve.add_argument("--cache-bytes", type=int, default=0,
                       help="hot-chunk cache budget (serving tier); "
                            "0 disables the cache + single-flight")
    serve.add_argument("--readahead", type=int, default=0,
                       help="streamed-download readahead depth (batches)")
    serve.add_argument("--download-slots", type=int, default=0,
                       help="concurrent download budget; 0 = unbounded")
    serve.add_argument("--upload-slots", type=int, default=0,
                       help="concurrent upload budget; 0 = unbounded")
    serve.add_argument("--internal-slots", type=int, default=0,
                       help="concurrent storage-plane bulk-op budget "
                            "(store/get chunks); 0 = unbounded")
    serve.add_argument("--queue-depth", type=int, default=64,
                       help="waiters beyond the slots before 503 shedding")
    serve.add_argument("--default-deadline", type=float, default=0.0,
                       help="end-to-end deadline (seconds) stamped on "
                            "HTTP requests without an X-Dfs-Deadline "
                            "header; 0 = none")
    serve.add_argument("--hedge-floor", type=float, default=0.02,
                       help="minimum hedged-read delay (seconds) before "
                            "a second replica is asked")
    serve.add_argument("--hedge-cap", type=float, default=0.5,
                       help="maximum hedged-read delay (seconds)")
    serve.add_argument("--hedge-budget", type=float, default=0.0,
                       help="hedge token-bucket refill per second; "
                            "0 disables hedged reads (the default)")
    serve.add_argument("--sidecar-port", type=int, default=None,
                       help="delegate chunk+hash to a running sidecar "
                            "process (overrides --fragmenter)")
    serve.add_argument("--ingest-window", type=int, default=2,
                       help="placement batches in flight while streaming")
    serve.add_argument("--ingest-flush-bytes", type=int,
                       default=32 * 1024 * 1024,
                       help="bytes a streaming placement batch collects")
    serve.add_argument("--ingest-credit-bytes", type=int,
                       default=64 * 1024 * 1024,
                       help="produced-but-unplaced chunk bytes before the "
                            "fragmenter thread waits")
    serve.add_argument("--replicate-inflight", type=int, default=2,
                       help="replication slices in flight per peer")
    serve.add_argument("--cas-io-threads", type=int, default=4,
                       help="worker threads of the local chunk store")
    serve.add_argument("--trace-ring", type=int, default=2048,
                       help="finished-span ring capacity (distributed "
                            "tracing); 0 disables tracing entirely")
    serve.add_argument("--slow-span", type=float, default=1.0,
                       help="slow threshold (s): trace stitcher slow "
                            "log AND the tail-retention outlier "
                            "detector")
    serve.add_argument("--tail-keep", type=int, default=256,
                       help="spans of slow/errored traces pinned "
                            "across ring churn; 0 disables tail "
                            "retention")
    serve.add_argument("--journal-bytes", type=int,
                       default=16 * 1024 * 1024,
                       help="flight-recorder on-disk budget (JSONL "
                            "event journal); 0 disables the journal")
    serve.add_argument("--journal-segment-bytes", type=int,
                       default=2 * 1024 * 1024,
                       help="journal segment rotation size")
    serve.add_argument("--sentinel-interval", type=float, default=1.0,
                       help="loop-lag/stall sentinel sampling period "
                            "(s); 0 disables sentinels")
    serve.add_argument("--sentinel-lag", type=float, default=0.25,
                       help="event-loop lag (s) above which the "
                            "sentinel journals a loop_lag incident")
    serve.add_argument("--census-interval", type=float, default=10.0,
                       help="metrics-history sample period (s); 0 turns "
                            "the sampler off (census queries still work)")
    serve.add_argument("--census-history-slots", type=int, default=360,
                       help="fine-resolution history buckets per series")
    serve.add_argument("--census-coarse-every", type=int, default=30,
                       help="fine steps folded into one coarse bucket")
    serve.add_argument("--census-coarse-slots", type=int, default=288,
                       help="coarse-resolution history buckets per series")
    serve.add_argument("--census-max-listed", type=int, default=64,
                       help="digests listed per census finding category")
    serve.add_argument("--ring-vnodes", type=int, default=0,
                       help="virtual nodes per unit weight on the "
                            "consistent-hash ring; 0 (default) = the "
                            "static epoch-0 placement")
    serve.add_argument("--ring-members", default="",
                       help="csv node ids owning digest space at epoch 0 "
                            "(the others are reachable standbys until "
                            "`ring add`); empty = every peer")
    serve.add_argument("--ring-rebalance-credit-bytes", type=int,
                       default=8 * 1024 * 1024,
                       help="online-rebalancer bound (payload bytes/s per "
                            "node); 0 = unthrottled")
    serve.add_argument("--durability", default="fsync",
                       choices=["fsync", "none"],
                       help="fsync every chunk and the manifest before the "
                            "ack (default), or not")
    serve.add_argument("--sim", action="store_true",
                       help="enable the similarity plane: min-hash sketches "
                            "of stored chunks on the node's device, a band "
                            "index, and chunks stored as deltas against "
                            "similar resident bases, transparent on read")
    serve.add_argument("--sim-sketch-size", type=int, default=16,
                       help="min-hash lanes per sketch")
    serve.add_argument("--sim-bands", type=int, default=4,
                       help="LSH bands per sketch (must divide the sketch "
                            "size)")
    serve.add_argument("--sim-shingle-bytes", type=int, default=8,
                       help="bytes per rolling shingle")
    serve.add_argument("--sim-max-candidates", type=int, default=8,
                       help="base candidates tried per new chunk")
    serve.add_argument("--sim-min-chunk-bytes", type=int, default=4096,
                       help="chunks below this are never sketched")
    serve.add_argument("--sim-min-savings-frac", type=float, default=0.5,
                       help="store a delta only at or below this fraction "
                            "of the raw size")
    serve.add_argument("--sim-max-delta-depth", type=int, default=3,
                       help="longest base chain a read may walk")
    serve.add_argument("--sim-devices", type=int, default=0,
                       help="device slots sketch batches are sharded over "
                            "(0/1 = the node's device)")
    serve.add_argument("--sim-rematerialize-reads", type=int, default=0,
                       help="reads after which a delta is stored raw again "
                            "(0 = never)")
    serve.add_argument("--index", action="store_true",
                       help="enable the dedup/index plane: persistent "
                            "log-structured digest index + peer-existence "
                            "filters; without it local existence stays one "
                            "stat per digest and placement probes every "
                            "digest over RPC")
    serve.add_argument("--index-memtable-entries", type=int, default=65536,
                       help="in-memory index entries before a flush to a "
                            "sorted on-disk run")
    serve.add_argument("--index-compact-runs", type=int, default=4,
                       help="sorted runs before a full compaction folds "
                            "them into one")
    serve.add_argument("--index-filter-bits", type=int, default=10,
                       help="peer-existence filter bloom bits per key; "
                            "0 = no filters (local index only)")
    serve.add_argument("--index-filter-sync", type=float, default=5.0,
                       help="peer-filter gossip cadence (s); 0 = no "
                            "background filter exchange")
    serve.add_argument("--index-background-compact", action="store_true",
                       help="run full index compactions on a dedicated "
                            "thread instead of the CAS workers")
    serve.add_argument("--index-echo-cache", type=int, default=0,
                       help="per-peer echo-confirmed existence cache "
                            "entries (0 = off): a digest whose hash echo "
                            "was confirmed this ring epoch skips even the "
                            "trust-verification probe on re-upload")
    serve.add_argument("--tier", action="store_true",
                       help="enable the hot/cold tiering plane: "
                            "temperature-driven demotion of cold files from "
                            "full replication to EC stripes (encoded on the "
                            "node's device), with transparent reads and "
                            "read-driven promotion")
    serve.add_argument("--tier-hot-fraction", type=float, default=0.1,
                       help="fraction of referenced bytes kept fully "
                            "replicated (the hot byte budget)")
    serve.add_argument("--tier-min-idle", type=float, default=300.0,
                       help="seconds a file must go unread before it may "
                            "be demoted, however cold it ranks")
    serve.add_argument("--tier-scan-interval", type=float, default=0.0,
                       help="demotion scan cadence (s); 0 = manual scans "
                            "only (POST /tier)")
    serve.add_argument("--tier-ec-k", type=int, default=4,
                       help="data chunks per parity stripe for demoted "
                            "files (needs k+2 ring members)")
    serve.add_argument("--tier-demote-credit-bytes", type=int,
                       default=8 * 1024 * 1024,
                       help="demotion/promotion byte budget per second "
                            "(0 = unmetered)")
    serve.add_argument("--tier-half-life", type=float, default=3600.0,
                       help="read-heat half-life (s): each read adds 1.0 "
                            "and the sum halves every half-life")
    serve.add_argument("--tier-promote-reads", type=float, default=2.0,
                       help="decayed heat at which a cold file "
                            "re-materializes replicated")
    serve.add_argument("--tier-redemote-cooldown", type=float, default=0.0,
                       help="seconds a freshly-promoted file sits out "
                            "demotion scans (0 = off)")
    serve.add_argument("--tier-ledger-entries", type=int, default=65536,
                       help="bounded temperature-ledger size (stalest "
                            "digests evict first)")
    serve.add_argument("--chaos", action="store_true",
                       help="enable the fault-injection plane: the "
                            "knobs below apply and POST /chaos "
                            "re-scripts them live; without this flag no "
                            "injector exists and every knob is ignored")
    serve.add_argument("--chaos-seed", type=int, default=0,
                       help="fault-decision RNG seed (xor'd with the "
                            "node id: per-node deterministic schedules)")
    serve.add_argument("--chaos-rpc-delay", type=float, default=0.0,
                       help="injected latency (s) before outbound "
                            "storage-plane calls")
    serve.add_argument("--chaos-rpc-delay-peers", default="",
                       help="csv node ids the rpc delay applies to "
                            "(empty = every peer)")
    serve.add_argument("--chaos-rpc-drop-rate", type=float, default=0.0,
                       help="probability an outbound call's connection "
                            "is dropped before the frame is sent")
    serve.add_argument("--chaos-partition", default="",
                       help="csv node ids unreachable FROM this node "
                            "(one-way; configure one side only for an "
                            "asymmetric partition)")
    serve.add_argument("--chaos-rpc-truncate-rate", type=float,
                       default=0.0,
                       help="probability an outbound frame is cut off "
                            "mid-body and the connection closed")
    serve.add_argument("--chaos-serve-delay", type=float, default=0.0,
                       help="injected delay (s) before serving each "
                            "inbound storage-plane op (a slow node)")
    serve.add_argument("--chaos-disk-error-rate", type=float,
                       default=0.0,
                       help="probability a CAS put/get raises EIO")
    serve.add_argument("--chaos-disk-full", action="store_true",
                       help="every CAS put raises ENOSPC (uploads "
                            "degrade to HTTP 507; reads keep working)")
    serve.add_argument("--chaos-disk-delay", type=float, default=0.0,
                       help="injected delay (s) before every CAS op "
                            "(slow disk; runs on the CAS workers)")
    serve.add_argument("--chaos-crash-point", default="",
                       help="registered crash-point name (see "
                            "dfs_tpu_torch.chaos.CRASH_POINTS): the "
                            "process SIGKILLs itself the first time "
                            "execution reaches it")
    serve.set_defaults(fn=cmd_serve)

    sc = sub.add_parser("sidecar", help="run the chunk+hash sidecar service")
    sc.add_argument("--sidecar-port", type=int, default=50151)
    sc.add_argument("--fragmenter", default="auto", choices=_FRAGMENTERS,
                    help=_FRAGMENTER_HELP)
    sc.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the device strategies chunk: the CUDA "
                         "card (default; fails without one) or the plain "
                         "versions on the CPU")
    sc.add_argument("--min-chunk", type=int, default=2048)
    sc.add_argument("--avg-chunk", type=int, default=8192)
    sc.add_argument("--max-chunk", type=int, default=65536)
    sc.set_defaults(fn=cmd_sidecar)

    sub.add_parser("status").set_defaults(fn=cmd_status)
    sub.add_parser("list").set_defaults(fn=cmd_list)
    up = sub.add_parser("upload")
    up.add_argument("file")
    up.add_argument("--resume", action="store_true",
                    help="probe the cluster and send only missing chunks")
    up.add_argument("--ec", type=int, default=0, metavar="K",
                    help="erasure-code with K data shards + P/Q parity "
                         "per stripe (needs K+2 cluster nodes; any two "
                         "lost shards per stripe are recoverable)")
    up.add_argument("--trace", action="store_true",
                    help="tag the request with a fresh trace id "
                         "(printed) for `trace <id>` inspection")
    _add_client_flags(up, device=True)
    up.set_defaults(fn=cmd_upload)
    down = sub.add_parser("download")
    down.add_argument("file_id")
    down.add_argument("--out", default=None)
    down.add_argument("--trace", action="store_true",
                      help="tag the request with a fresh trace id "
                           "(printed) for `trace <id>` inspection")
    _add_client_flags(down, device=False)
    down.set_defaults(fn=cmd_download)
    rm = sub.add_parser("delete")
    rm.add_argument("file_id")
    rm.set_defaults(fn=cmd_delete)
    mt = sub.add_parser("metrics")
    mt.add_argument("--prom", action="store_true",
                    help="OpenMetrics text exposition instead of JSON")
    mt.set_defaults(fn=cmd_metrics)
    ev = sub.add_parser("events",
                        help="recent flight-recorder lifecycle events")
    ev.add_argument("--since", type=float, default=0.0,
                    help="unix-seconds lower bound (default: all "
                         "retained)")
    ev.add_argument("--limit", type=int, default=256,
                    help="newest events returned (1..4096)")
    ev.set_defaults(fn=cmd_events)
    dr = sub.add_parser("doctor",
                        help="cluster diagnosis (named pathologies and "
                             "their evidence)")
    dr.add_argument("--local", action="store_true",
                    help="diagnose the contacted node only")
    dr.add_argument("--json", action="store_true",
                    help="also print the full report as JSON")
    dr.set_defaults(fn=cmd_doctor)
    cn = sub.add_parser("census",
                        help="replication census (copies histogram, "
                             "under-/over-replicated and orphaned digests)")
    cn.add_argument("--local", action="store_true",
                    help="inventory the contacted node only")
    cn.add_argument("--json", action="store_true",
                    help="also print the full report as JSON")
    cn.set_defaults(fn=cmd_census)
    df = sub.add_parser("df",
                        help="cluster capacity: per-node CAS bytes, disk "
                             "headroom, dedup ratio")
    df.set_defaults(fn=cmd_df)
    rg = sub.add_parser("ring",
                        help="show or change the placement ring (epoch-"
                             "versioned; changes rebalance online)")
    rg.add_argument("action",
                    choices=["status", "add", "drain", "remove",
                             "reweight"])
    rg.add_argument("node", type=int, nargs="?", default=None,
                    help="target node id (every action but status)")
    rg.add_argument("--weight", type=float, default=None,
                    help="member weight (add/reweight); add without it "
                         "derives one from disk headroom")
    rg.set_defaults(fn=cmd_ring)
    tr = sub.add_parser("trace",
                        help="render a stitched cross-node trace")
    tr.add_argument("trace_id")
    tr.add_argument("--slow", type=float, default=None,
                    help="slow-span threshold (s); default: the node's "
                         "configured slow_span_s")
    tr.set_defaults(fn=cmd_trace)
    sub.add_parser("menu").set_defaults(fn=cmd_menu)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
