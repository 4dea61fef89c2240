#!/usr/bin/env python3
"""Run one cell of the benchmark of dfs_tpu_torch and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. One run is one process: it builds the
kernels, starts the configuration's nodes (``dfs_tpu_torch.cli.main
serve``) on localhost with their data under ``$TMPDIR``, starts the mix's
agents (:mod:`portbench.generator`), which store their base files and
their warm uploads (set-up), then lets the agents upload for ``--seconds``
(the window). After the window it checks every acknowledged upload
against the plain reference (:mod:`portbench.reference`), stops every
process it started, and prints one JSON line. ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, read by
``metrics/<name>.py`` from the nodes' counters, the card's utilization and
a profiled replay of the fragmenter (:mod:`portbench.replay`).

Exit codes: 0 a result was printed; 2 bad arguments or registry; 3 no
card, or fewer than the cell needs; 4 JAX or dfs_tpu was loaded; 1 any
other failure. Only a 0 prints a result.
"""

from __future__ import annotations

import time

_T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import multiprocessing  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent

FORBIDDEN = ("jax", "jaxlib", "flax", "dfs_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or dfs_tpu's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def nearest_rank(values: list[float], q: float) -> float:
    """The ``q`` quantile by nearest rank: the ``ceil(q n)``-th smallest."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def parse(argv: list[str] | None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the benchmark's own tests and its control, never the driver's
    ap.add_argument("--benchmark-file", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--registry", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--no-chip", action="store_true", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def say(*parts) -> None:
    print("portbench:", *parts, file=sys.stderr, flush=True)


class Context(types.SimpleNamespace):
    """What a per-layer metric's reader reads: the nodes' ``/metrics``
    before and after the window, the bytes acknowledged in it and the
    latencies of those uploads, the card's samples in it, the replay's
    readings."""

    def delta(self, fn) -> float:
        return sum(fn(self.after[i]) - fn(self.before[i])
                   for i in self.after)

    def per_gib(self, x: float) -> float | None:
        return x / (self.acked_bytes / 2**30) if self.acked_bytes else None

    def latency_ms(self, q: float) -> float | None:
        """The ``q`` quantile of the window's upload latencies."""
        return nearest_rank(self.latencies_ms, q) if self.latencies_ms \
            else None


def device_info(chip: bool, cell: dict, samples: list) -> dict:
    """The result's ``device``: the card's name, and the peak of memory in
    use on it across the window's ``nvidia-smi`` samples (every process)."""
    kind = "none"
    if chip:
        import torch

        kind = torch.cuda.get_device_name(0)
    return {"platform": "gpu" if chip else "cpu", "kind": kind,
            "count": cell["chips"], "memory_peak_bytes": int(max(
                (s[2] for s in samples), default=0) * 2**20)}


def emit(result: dict) -> int:
    """Prints the checks, each number beside its limit, as the last lines
    of standard error and the result as the last line of standard output
    (``checks`` its last key); refuses to, with exit 4, once JAX or
    dfs_tpu is loaded."""
    found = forbidden_modules()
    if found:
        say("loaded, and must not be: " + ", ".join(found))
        return 4
    for k, c in result["checks"].items():
        kind = ">=" if c.get("at_least") else "=="
        say(f"check {k}: {c['value']} (limit {kind} {c['limit']})")
    result["checks"] = result.pop("checks")
    print(json.dumps(result), flush=True)
    return 0


def _recv(conn, what: str, timeout: float):
    if not conn.poll(timeout):
        raise RuntimeError(f"an agent sent no {what} within {timeout:.0f} s")
    msg = conn.recv()
    if msg[0] != what:
        raise RuntimeError(f"an agent sent {msg[0]!r}, not {what!r}")
    return msg


def run(args: argparse.Namespace) -> int:
    from portbench import registry

    try:
        bench = registry.load_benchmark(args.benchmark_file)
        cell = registry.workload(bench, args.workload)
        root = args.registry or registry.HERE
        cfg = registry.load_config(cell["config"], root)
        mix = registry.load_mix(cell["traffic"], root)
    except (registry.RegistryError, KeyError, ValueError, OSError) as e:
        say(f"registry: {e}")
        return 2
    chip = not args.no_chip
    if chip:
        import torch

        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            say(f"needs {cell['chips']} CUDA card(s); "
                f"available={torch.cuda.is_available()}, "
                f"count={torch.cuda.device_count()}")
            return 3
    from portbench import cluster as clusters
    from portbench import generator, hostload, replay, smi
    from portbench.reference import anchored

    info = {}
    uuid = None
    if chip:
        uuid = smi.visible_uuid()
        info["card"] = smi.card_info(uuid)
        from dfs_tpu_torch import kernels

        t = time.monotonic()
        kernels.build_all()
        info["kernel_build_s"] = time.monotonic() - t
    tmp = Path(tempfile.mkdtemp(prefix=f"portbench-{args.workload}-"))
    nodes = clusters.Cluster(cfg, tmp, fault=args.fault)
    sampler = smi.Sampler(uuid) if chip else None
    agents = []
    try:
        info["nodes_up_s"] = nodes.start()
        mp = multiprocessing.get_context("spawn")
        for a in range(mix["agents"]):
            here, there = mp.Pipe()
            node = nodes.ids[a % len(nodes.ids)]
            p = mp.Process(target=generator.agent_main, args=(
                there, mix, args.seed, a, nodes.port[node], cfg["chunk"]),
                daemon=True)
            p.start()
            agents.append(types.SimpleNamespace(conn=here, proc=p, node=node,
                                                a=a))
        t_setup = time.monotonic()
        for ag in agents:
            ag.setup = _recv(ag.conn, "ready", 900)[1]
        info["agents_setup_s"] = time.monotonic() - t_setup
        setup = [r for ag in agents for r in ag.setup]
        bad = [r for r in setup if r["status"] != 201]
        if bad:
            # the system failed before the window: no window, not correct
            say(f"{len(bad)} set-up upload(s) failed, the first: "
                f"{bad[0]['status']} {bad[0]['error']}")
            nodes.stop()
            return emit({"correct": False, "attempted": len(setup),
                         "failed": len(bad), "metrics": {},
                         "device": device_info(chip, cell, []),
                         "checks": {"setup_uploads_failed": {
                             "value": len(bad), "limit": 0}}})
        # agents start staggered by a fifth of a warm upload's time each,
        # so that at the window's start every agent is busy and their
        # acknowledgements fall evenly through it
        warm = sorted(ag.setup[-1]["t_end"] - ag.setup[-1]["t_start"]
                      for ag in agents)
        lead = warm[len(warm) // 2]
        t = time.monotonic()
        files0 = nodes.files()
        # the set-up's writes go to the disk now, not inside the window
        os.sync()
        info["files_walk_and_sync_s"] = time.monotonic() - t
        t0 = time.monotonic() + 1.0 + lead
        t1 = t0 + args.seconds
        for ag in agents:
            ag.conn.send(("go", t0 - lead + ag.a * lead / len(agents), t1))
        groups = {"nodes": nodes.pids(),
                  "agents": [ag.proc.pid for ag in agents],
                  "harness": [os.getpid()],
                  "nvidia_smi": [sampler.pid] if sampler else []}
        time.sleep(max(0.0, t0 - time.monotonic()))
        host0 = hostload.snapshot(groups)
        before = nodes.metrics()
        setup_s = t0 - _T_START
        time.sleep(max(0.0, t1 - time.monotonic()))
        host1 = hostload.snapshot(groups)
        after = nodes.metrics()
        samples = sampler.samples(t0, t1) if sampler else []
        for ag in agents:
            _, ag.records, ag.build = _recv(ag.conn, "done", 300)
        grown = nodes.grown_bytes(files0)

        records = [(ag, r) for ag in agents for r in ag.records]
        acked = [(ag, r) for ag, r in records if r["status"] == 201]
        in_window = [r for _, r in acked if t0 <= r["t_end"] <= t1]
        acked_bytes = sum(r["bytes"] for r in in_window)
        lat_ms = [(r["t_end"] - r["t_start"]) * 1e3 for r in in_window]
        metrics = {}
        if in_window:
            metrics = {
                "upload_GiBps": {"value": acked_bytes / 2**30 / args.seconds,
                                 "unit": "GiB/s"},
                "upload_p90_ms": {"value": nearest_rank(lat_ms, 0.90),
                                  "unit": "ms"},
                "write_amp": {"value": grown / max(
                    1, sum(r["bytes"] for _, r in acked)), "unit": "ratio"},
                "setup_s": {"value": setup_s, "unit": "s"}}
        say(f"window: {len(in_window)} uploads acknowledged in "
            f"{args.seconds:g} s ({acked_bytes} B); {len(records)} started "
            f"from {lead:.3f} s before it, {len(acked)} acknowledged in all;"
            f" latency samples {len(lat_ms)}, median "
            f"{nearest_rank(lat_ms, 0.5) if lat_ms else 0:.1f} ms; the data"
            f" root grew {grown} B")
        say("latencies_ms: " + json.dumps(
            {f"agent{ag.a}": [round((r["t_end"] - r["t_start"]) * 1e3, 1)
                              for r in ag.records] for ag in agents}))
        say("generator: " + json.dumps(
            {f"agent{ag.a}": ag.build for ag in agents}))
        bins = [0] * max(1, math.ceil(args.seconds / 5))
        for r in in_window:
            bins[min(len(bins) - 1, int((r["t_end"] - t0) // 5))] += 1
        say("host: " + json.dumps({
            "cores": os.cpu_count(), "acks_per_5s": bins,
            **hostload.window(host0, host1, args.seconds)}))

        # -- the comparison that decides `correct` ------------------------
        rng = random.Random(f"{args.seed}:sample")
        sample = []
        for ag in agents:
            mine = [r for r in ag.records if r["status"] == 201]
            k = min(len(mine), mix.get("sample_per_agent", 1))
            sample += [(ag, r) for r in rng.sample(mine, k)]
        checks = {"uploads_failed": len(records) - len(acked),
                  "acks_below_quorum": sum(
                      1 for _, r in acked
                      if (r["resp"].get("minCopies") or 0)
                      < cfg["write_quorum"]),
                  "nodes_not_durable": sum(
                      1 for m in after.values()
                      if m["durability"]["mode"] != cfg["durability"])}
        tables, bodies = {}, []
        download_bad = 0
        for ag, r in sample:
            other = nodes.ids[(nodes.ids.index(ag.node) + 1)
                              % len(nodes.ids)]
            fid = r["resp"]["fileId"]
            tables[(ag.a, r["g"])] = nodes.manifest_table(nodes.port[other],
                                                          fid)
            data = generator.body(mix, args.seed, ag.a, "window", r["g"],
                                  generator.base_file(mix, args.seed, ag.a))
            got = nodes.download(nodes.port[other], fid)
            download_bad += got is None or got != data.tobytes()
            del got
            bodies.append(data)
        checks["downloads_not_identical"] = download_bad
        nodes.stop()
        if sampler:
            sampler.stop()
        for ag in agents:
            ag.conn.send(("verify", [r["g"] for a2, r in sample
                                     if a2 is ag]))
        ref = {}
        fid_bad = 0
        for ag in agents:
            _, sums, reftab = _recv(ag.conn, "verified", 600)
            for r in ag.records:
                if r["status"] == 201:
                    fid_bad += r["resp"]["fileId"] != sums[r["g"]]
            for g, t in reftab.items():
                ref[(ag.a, g)] = t
        checks["file_ids_wrong"] = fid_bad
        checks["tables_not_equal"] = sum(
            1 for k in ref if tables.get(k) != [tuple(c) for c in ref[k]])
        missing = 0
        for k in ref:
            for dg in {c[2] for c in ref[k]}:
                for o in anchored.replica_set(dg, nodes.ids,
                                              cfg["replication_factor"]):
                    p = nodes.chunk_path(o, dg)
                    missing += not (p.is_file() and anchored.file_id(
                        p.read_bytes()) == dg)
        checks["replicas_missing"] = missing
        checks["reference_tables"] = len(ref)
        limits = {k: 0 for k in checks}
        # at least one table compared: a run that compared nothing proves
        # nothing
        limits["reference_tables"] = 1
        correct = all(v == limits[k] for k, v in checks.items()
                      if k != "reference_tables") \
            and checks["reference_tables"] >= limits["reference_tables"]

        # -- per-layer readings -------------------------------------------
        device = device_info(chip, cell, samples)
        result = {"correct": correct, "attempted": len(records),
                  "failed": len(records) - len(acked)}
        rep = None
        if args.trace and chip:
            rep = replay.run(cfg, bodies, mix["block_bytes"],
                             tmp / "replay_trace.json")
            device["busy_s"] = rep["busy_s"]
            device["window_s"] = rep["window_s"]
            device["memory_peak_bytes"] = max(device["memory_peak_bytes"],
                                              rep["memory_peak_bytes"])
            say(f"replay: engine {rep['engine']}, {rep['bytes']} B in "
                f"{rep['timed_s']:.4f} s; profiled {rep['profiled_bytes']}"
                f" B, {rep['device_op_count']} device ops, busy "
                f"{rep['busy_s']:.6f} s of {rep['window_s']:.6f} s")
        if args.trace:
            ctx = Context(before=before, after=after, window_s=args.seconds,
                          acked_bytes=acked_bytes, latencies_ms=lat_ms,
                          smi=samples, replay=rep,
                          profiled_lengths=[
                              [c[1] for c in ref[(ag.a, r["g"])]]
                              for ag, r in sample[:2]])
            out = {}
            for m in registry.cell_metrics(bench, args.workload,
                                           "per_layer"):
                v = registry.load_reader(m["name"], root).read(ctx)
                if v is not None:
                    out[m["name"]] = {"value": v, "unit": m["unit"]}
            metrics = out
            if rep is not None:
                result["breakdown"] = {"device_ops": rep["device_ops"],
                                       "idle_gaps": rep["idle_gaps"]}
        else:
            wanted = {m["name"] for m in registry.cell_metrics(
                bench, args.workload, "end_to_end")}
            metrics = {k: v for k, v in metrics.items() if k in wanted}
        result["metrics"] = metrics
        result["device"] = device
        result["checks"] = {k: {"value": v, "limit": limits[k]}
                            for k, v in checks.items()}
        result["checks"]["reference_tables"]["at_least"] = True
        info["setup_s"] = setup_s
        info["disk_bytes_grown_in_window"] = grown
        info["disk_bytes_at_end"] = nodes.total_bytes()
        say("run: " + json.dumps(info))
        return emit(result)
    except BaseException:
        say("node log tails:\n" + nodes.log_tails())
        raise
    finally:
        if sampler:
            sampler.stop()
        for ag in agents:
            try:
                ag.conn.send(("stop",))
            except OSError:
                pass
        for ag in agents:
            ag.proc.join(timeout=30)
            if ag.proc.is_alive():
                ag.proc.kill()
                ag.proc.join(timeout=30)
        nodes.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    args = parse(argv)
    try:
        return run(args)
    except Exception as e:  # noqa: BLE001 — the run fails with no result
        import traceback

        traceback.print_exc()
        say(f"failed: {type(e).__name__}: {e}")
        return 1


if __name__ == "__main__":
    # the package is imported from the checkout's root, never by the
    # module names of its own directory
    sys.path[0] = str(CHECKOUT)
    sys.exit(main())
