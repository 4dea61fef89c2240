"""Typed configuration of the port: a copy of the parts of dfs_tpu's
``config.py`` that a default node honours.

- :class:`CDCParams` — operator chunk sizing (``--min/avg/max-chunk``);
  ``fragmenter.base._anchored_params`` maps it onto the anchored grid
  exactly as dfs_tpu does, so the same flags cut the same chunks; the
  ``cdc`` host strategy uses it as it stands (Gear table seed and mask).
- :class:`PeerAddr`, :class:`ClusterConfig` — membership and replication.
- :class:`FragmenterConfig` — how the chunk-and-hash chain runs.
- :class:`IngestConfig` — the pipelined write path's bounds.
- :class:`ObsConfig` — tracing, the flight-recorder journal and the
  sentinels, on by default as in dfs_tpu.
- :class:`DurabilityConfig` — fsync before the ack, or not.
- :class:`ChaosConfig` — deterministic fault injection, default off.
- :class:`SimConfig` — the similarity plane (min-hash sketches, band
  index, delta-encoded chunks), default off.
- :class:`ServeConfig` — the serving tier (hot-chunk cache, single-flight,
  admission gates, deadlines, hedged reads and writes, readahead), default
  off.
- :class:`IndexConfig` — the dedup/index plane (digest LSI, peer-existence
  filters), default off.
- :class:`TierConfig` — the hot/cold tiering plane (temperature ledger,
  demotion to EC, promotion), default off.
- :class:`CensusConfig` — the census and the metrics-history sampler.
- :class:`RingConfig` — the elastic ring: vnodes, epoch-0 members and the
  rebalance byte credits.
- :class:`ClientConfig` — the smart client's knobs (``SmartClient``,
  ``upload``/``download --smart``); not a node setting, and without a
  device field: the client's device is a constructor argument.
- :class:`NodeConfig` — one node. It holds only the fields the port's
  runtime honours. ``device`` is the port's own: ``None`` means the CUDA
  card (raising without one), ``"cpu"`` the plain versions.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

# the uint32 Gear hash with shift 1 forgets bytes older than 32 positions
# (they shift out mod 2**32): the rolling ``cdc`` strategy's window, and
# the halo a tile of its bitmap needs from the tile before
GEAR_WINDOW = 32
GEAR_HALO = GEAR_WINDOW - 1


@dataclasses.dataclass(frozen=True)
class CDCParams:
    """Content-defined-chunking sizes in bytes (``avg_size`` a power of
    two) and the Gear table's seed. The anchored strategy quantizes the
    sizes to its 64-byte grid; the ``cdc`` strategy cuts where
    ``(gear_hash & mask) == 0`` at ``min_size`` or more, or at
    ``max_size``. ``WINDOW`` is dfs_tpu's constant field (it also keeps
    the two packages' config fingerprints equal)."""

    min_size: int = 2048
    avg_size: int = 8192
    max_size: int = 65536
    seed: int = 0x9E3779B9

    WINDOW: int = dataclasses.field(default=GEAR_WINDOW, init=False,
                                    repr=False)

    def __post_init__(self) -> None:
        if self.avg_size & (self.avg_size - 1):
            raise ValueError(
                f"avg_size must be a power of two, got {self.avg_size}")
        if not (0 < self.min_size <= self.avg_size <= self.max_size):
            raise ValueError(
                f"need 0 < min ({self.min_size}) <= avg ({self.avg_size})"
                f" <= max ({self.max_size})")

    @property
    def mask(self) -> int:
        return self.avg_size - 1


@dataclasses.dataclass(frozen=True)
class PeerAddr:
    """One node's addresses: the external HTTP port and the binary
    storage-plane port."""

    node_id: int
    host: str
    port: int           # external HTTP API port
    internal_port: int  # binary storage-plane port

    @property
    def http_base(self) -> str:
        return f"http://{self.host}:{self.port}"


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Cluster membership + replication policy. The reference deployment
    is 5 nodes with cyclic replication x2."""

    peers: tuple[PeerAddr, ...]
    replication_factor: int = 2

    def __post_init__(self) -> None:
        if len({p.node_id for p in self.peers}) != len(self.peers):
            raise ValueError("duplicate node_id in cluster config")
        if not 1 <= self.replication_factor <= max(1, len(self.peers)):
            raise ValueError("replication_factor out of range")

    @property
    def n_nodes(self) -> int:
        return len(self.peers)

    def peer(self, node_id: int) -> PeerAddr:
        for p in self.peers:
            if p.node_id == node_id:
                return p
        raise KeyError(f"unknown node_id {node_id}")

    def sorted_ids(self) -> list[int]:
        return sorted(p.node_id for p in self.peers)

    @staticmethod
    def from_file(path: str | Path) -> "ClusterConfig":
        """Membership from JSON or TOML::

            {"replication_factor": 2,
             "peers": [{"node_id": 1, "host": "10.0.0.1",
                        "port": 5001, "internal_port": 6001}, ...]}

        TOML uses a ``[[peers]]`` array of tables with the same keys."""
        path = Path(path)
        text = path.read_text()
        if path.suffix == ".toml":
            import tomllib

            d = tomllib.loads(text)
        else:
            d = json.loads(text)
        return ClusterConfig(
            peers=tuple(PeerAddr(**p) for p in d["peers"]),
            replication_factor=int(d.get("replication_factor", 2)))

    @staticmethod
    def localhost(n_nodes: int, base_port: int = 5001,
                  base_internal_port: int = 6001,
                  replication_factor: int = 2) -> "ClusterConfig":
        """N localhost nodes: node i on base_port + i - 1 (HTTP) and
        base_internal_port + i - 1 (storage plane)."""
        peers = tuple(
            PeerAddr(node_id=i + 1, host="127.0.0.1",
                     port=base_port + i, internal_port=base_internal_port + i)
            for i in range(n_nodes))
        return ClusterConfig(peers=peers,
                             replication_factor=replication_factor)


@dataclasses.dataclass(frozen=True)
class FragmenterConfig:
    """``devices > 1`` runs the anchored walk window-batched over that many
    device slots (``fragmenter/cdc_anchored_sharded.py``): one whole window
    per slot; and the ``cdc`` walk's Gear bitmap tiled over them
    (``fragmenter/cdc_sharded.py``). Chunk tables are byte-identical to
    the single-device walk. With fewer devices visible than configured the
    walk raises (dfs_tpu logs and runs single-device instead)."""

    devices: int = 0        # 0/1 = single-device walk; N > 1 = N slots
    region_bytes: int = 0   # fixed region size of the sharded walk; 0 =
                            # 64 MiB split across the window batch
                            # (anchored), devices MiB (rolling)
    staging_buffers: int = 2  # window batches in flight in the sharded
                            # walk: 2 = stage batch k+1 while batch k
                            # computes; 1 = strictly serial staging

    def __post_init__(self) -> None:
        if self.devices < 0:
            raise ValueError("devices must be >= 0")
        if self.region_bytes < 0:
            raise ValueError("region_bytes must be >= 0")
        if self.staging_buffers < 1:
            raise ValueError("staging_buffers must be >= 1")


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """Bounds of the pipelined write path: placement batches in flight,
    the batch size, the byte credit between the fragmenter thread and the
    placement loop, replication slices in flight per peer, and the CAS
    worker threads. ``window=1`` with ``slice_inflight=1`` is the strictly
    serial schedule."""

    window: int = 2
    flush_bytes: int = 32 * 1024 * 1024
    credit_bytes: int = 64 * 1024 * 1024
    slice_inflight: int = 2
    cas_io_threads: int = 4

    def __post_init__(self) -> None:
        if self.window < 1:
            raise ValueError("window must be >= 1")
        if self.flush_bytes <= 0 or self.credit_bytes <= 0:
            raise ValueError("flush_bytes/credit_bytes must be > 0")
        if self.slice_inflight < 1:
            raise ValueError("slice_inflight must be >= 1")
        if self.cas_io_threads < 1:
            raise ValueError("cas_io_threads must be >= 1")


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability (:mod:`dfs_tpu_torch.obs`): distributed tracing, the
    flight-recorder journal, tail retention of outlier traces and the
    stall sentinels, with dfs_tpu's fields, defaults and validation.

    Tracing defaults ON: always-on cheap tracing is what makes the one
    slow request diagnosable after the fact. ``trace_ring=0`` turns span
    collection and context propagation off (the wire and header carriers
    are never attached); the journal, the sentinels and tail retention
    are on by default too, each zeroable. RPC metrics stay on either way.
    """

    trace_ring: int = 2048      # finished-span ring capacity per node;
                                # 0 = tracing fully off
    slow_span_s: float = 1.0    # slow threshold (s): stitcher slow log
                                # AND the tail-retention outlier detector
    tail_keep: int = 256        # pinned spans of slow/errored traces
                                # that survive ring churn; 0 = tail
                                # retention off (outliers evict normally)
    journal_bytes: int = 16 * 1024 * 1024   # flight-recorder on-disk
                                # budget (JSONL segments); 0 = no journal
    journal_segment_bytes: int = 2 * 1024 * 1024  # journal segment
                                # rotation size (oldest segments are
                                # deleted to hold the total budget)
    sentinel_interval_s: float = 1.0  # loop-lag / stall sampler period;
                                # 0 = sentinels off
    sentinel_lag_s: float = 0.25      # event-loop lag above which the
                                # sentinel journals a loop_lag incident

    def __post_init__(self) -> None:
        if self.trace_ring < 0:
            raise ValueError("trace_ring must be >= 0")
        if self.slow_span_s <= 0:
            raise ValueError("slow_span_s must be > 0")
        if self.tail_keep < 0:
            raise ValueError("tail_keep must be >= 0")
        if self.journal_bytes < 0 or self.journal_segment_bytes <= 0:
            raise ValueError("journal_bytes must be >= 0 and "
                             "journal_segment_bytes > 0")
        if self.sentinel_interval_s < 0:
            raise ValueError("sentinel_interval_s must be >= 0")
        if self.sentinel_lag_s <= 0:
            raise ValueError("sentinel_lag_s must be > 0")


@dataclasses.dataclass(frozen=True)
class DurabilityConfig:
    """``mode="fsync"`` (the default): every chunk put and the manifest
    save that acks an upload are fsync'd (file, then directory) before
    they return. ``mode="none"``: atomic renames without barriers."""

    mode: str = "fsync"   # "fsync" | "none"

    def __post_init__(self) -> None:
        if self.mode not in ("fsync", "none"):
            raise ValueError(f"durability mode must be 'fsync' or "
                             f"'none', got {self.mode!r}")

    @property
    def fsync(self) -> bool:
        return self.mode == "fsync"


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Deterministic fault injection (:mod:`dfs_tpu_torch.chaos`), with
    dfs_tpu's fields, defaults and validation.

    Everything defaults off: ``enabled=False`` means the node holds no
    injector at all. With ``enabled=True`` the node builds a
    :class:`dfs_tpu_torch.chaos.ChaosInjector` seeded from ``seed ^
    node_id``, applies the knobs below, and accepts ``POST /chaos``.

    - ``rpc_delay_s`` / ``rpc_delay_peers``: outbound storage-plane calls
      to the named peers (csv of node ids; empty = all) sleep first.
    - ``rpc_drop_rate``: probability an outbound call's connection drops.
    - ``partition``: csv of peer node ids this node cannot reach at all
      (one-way).
    - ``rpc_truncate_rate``: probability an outbound frame is cut off
      mid-frame and the connection closed.
    - ``serve_delay_s``: inbound storage-plane ops on this node sleep
      before dispatch (a slow node).
    - ``disk_error_rate``: probability a CAS put/get raises EIO.
    - ``disk_full``: every CAS put raises ENOSPC (uploads answer 507).
    - ``disk_delay_s``: every CAS op sleeps first, on the CAS workers.
    - ``crash_point``: a registered crash point
      (``dfs_tpu_torch.chaos.CRASH_POINTS``); the process dies by SIGKILL
      the first time execution reaches it.
    """

    enabled: bool = False
    seed: int = 0
    rpc_delay_s: float = 0.0
    rpc_delay_peers: str = ""     # csv node ids; "" = every peer
    rpc_drop_rate: float = 0.0
    partition: str = ""           # csv node ids unreachable from here
    rpc_truncate_rate: float = 0.0
    serve_delay_s: float = 0.0
    disk_error_rate: float = 0.0
    disk_full: bool = False
    disk_delay_s: float = 0.0
    crash_point: str = ""

    def __post_init__(self) -> None:
        for f in ("rpc_delay_s", "serve_delay_s", "disk_delay_s"):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0")
        for f in ("rpc_drop_rate", "rpc_truncate_rate",
                  "disk_error_rate"):
            if not 0.0 <= getattr(self, f) <= 1.0:
                raise ValueError(f"{f} must be in [0, 1]")
        for f in ("rpc_delay_peers", "partition"):
            spec = getattr(self, f)
            if not isinstance(spec, str):
                raise ValueError(f"{f} must be a csv string of node "
                                 f"ids, got {type(spec).__name__}")
            if spec and not all(
                    p.strip().isdigit() for p in spec.split(",")):
                raise ValueError(f"{f} must be a csv of node ids, "
                                 f"got {spec!r}")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Similarity-compression plane (:mod:`dfs_tpu_torch.sim`): batched
    min-hash sketches over stored chunks, a banded similarity lookup, and
    delta-encoded chunk storage in the CAS. A copy of dfs_tpu's.

    Everything defaults off: ``SimConfig()`` builds no sketcher, no band
    index and no delta tree, and ``ChunkStore`` writes raw chunk files
    only. ``enabled=True`` builds the :class:`~dfs_tpu_torch.sim.SimPlane`:

    - every locally stored chunk of at least ``min_chunk_bytes`` is
      sketched (``sketch_size`` min-hash lanes over ``shingle_bytes``-byte
      shingles) on the node's device, over ``devices`` slots when > 1;
    - the sketch's ``bands`` band keys feed a crash-safe append-only band
      log; a new chunk's bands look up at most ``max_candidates`` resident
      bases;
    - a chunk whose best candidate delta-encodes to at most
      ``min_savings_frac`` of its raw size is stored as ``base-digest +
      patch`` (read: resolve the base, apply, sha256-verify), chains
      capped at ``max_delta_depth`` and re-materialized raw after
      ``rematerialize_reads`` reads.
    """

    enabled: bool = False
    sketch_size: int = 16           # min-hash lanes per sketch (uint32
                                    # each); bands must divide it
    bands: int = 4                  # LSH bands per sketch, each one
                                    # lookup key
    shingle_bytes: int = 8          # bytes per rolling shingle feature
    max_candidates: int = 8         # resident base candidates consulted
                                    # per new chunk
    min_chunk_bytes: int = 4096     # smaller chunks are never sketched
                                    # or delta-encoded
    min_savings_frac: float = 0.5   # store a delta only if the patch is
                                    # at most this fraction of the raw size
    max_delta_depth: int = 3        # longest base chain a reconstruct
                                    # may walk
    devices: int = 0                # sketch batches over this many device
                                    # slots (0/1 = the node's device)
    rematerialize_reads: int = 0    # delta reads before the chunk is
                                    # re-materialized raw; 0 = never

    def __post_init__(self) -> None:
        if self.sketch_size < 1:
            raise ValueError("sketch_size must be >= 1")
        if not 1 <= self.bands <= self.sketch_size \
                or self.sketch_size % self.bands:
            raise ValueError("bands must divide sketch_size")
        if not 1 <= self.shingle_bytes <= 64:
            raise ValueError("shingle_bytes must be within [1, 64]")
        if self.max_candidates < 1:
            raise ValueError("max_candidates must be >= 1")
        if self.min_chunk_bytes < 0:
            raise ValueError("min_chunk_bytes must be >= 0")
        if not 0.0 < self.min_savings_frac <= 1.0:
            raise ValueError("min_savings_frac must be within (0, 1]")
        if self.max_delta_depth < 1:
            raise ValueError("max_delta_depth must be >= 1")
        if self.devices < 0:
            raise ValueError("devices must be >= 0")
        if self.rematerialize_reads < 0:
            raise ValueError("rematerialize_reads must be >= 0")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The serving tier (:mod:`dfs_tpu_torch.serve`), a copy of dfs_tpu's:
    hot-chunk cache, single-flight coalescing, admission control,
    end-to-end deadlines, hedged reads and writes, readahead.

    Everything defaults off: a node built from ``ServeConfig()`` runs the
    read, write and internal paths it runs without the tier; each knob
    enables one component.
    """

    cache_bytes: int = 0        # hot-chunk cache budget; 0 = no cache
                                # (and no single-flight read path: the
                                # two ride one switch)
    readahead_batches: int = 0  # streamed-download readahead depth K;
                                # 0 = fetch batches one at a time
    download_slots: int = 0     # concurrent GET /download budget; 0 = no
                                # gate
    upload_slots: int = 0       # concurrent POST /upload budget
    internal_slots: int = 0     # concurrent storage-plane bulk ops
    queue_depth: int = 64       # waiters beyond the slots before shedding
    retry_after_s: float = 1.0  # advertised in a 503's Retry-After
    default_deadline_s: float = 0.0  # deadline stamped on client routes
                                # without an X-Dfs-Deadline header; 0 = none
    hedge_floor_s: float = 0.02  # never hedge sooner than this
    hedge_cap_s: float = 0.5    # hedge a replica slower than this even if
                                # its history says it used to be slower
    hedge_budget_per_s: float = 0.0  # hedge token-bucket refill per
                                # second; the master switch, 0 = no hedging

    def __post_init__(self) -> None:
        if self.cache_bytes < 0:
            raise ValueError("cache_bytes must be >= 0")
        if self.readahead_batches < 0:
            raise ValueError("readahead_batches must be >= 0")
        if self.queue_depth < 0:
            raise ValueError("queue_depth must be >= 0")
        if self.default_deadline_s < 0:
            raise ValueError("default_deadline_s must be >= 0")
        if self.hedge_floor_s < 0 or self.hedge_cap_s < self.hedge_floor_s:
            raise ValueError("need 0 <= hedge_floor_s <= hedge_cap_s")
        if self.hedge_budget_per_s < 0:
            raise ValueError("hedge_budget_per_s must be >= 0")


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Dedup/index plane (:mod:`dfs_tpu_torch.index`), a copy of
    dfs_tpu's: persistent log-structured digest index + delta-gossiped
    peer-existence filters.

    Everything defaults off: ``IndexConfig()`` builds no index and no
    filters — ``ChunkStore.has`` stays one stat syscall, placement
    probes every digest over RPC, and the node runs the code paths it
    runs without the plane. ``enabled=True`` builds the
    :class:`~dfs_tpu_torch.index.IndexPlane`:

    - local existence answers come from the log-structured index (one
      memtable hit or one fenced ``pread``), with the stat call kept
      as the negative-confirmation backstop;
    - each node maintains a blocked-bloom filter over its own digest
      set (``filter_bits_per_key`` sizes it; 0 = index only, no
      filter exchange), replicated to peers via ``get_filter`` /
      ``filter_delta`` every ``filter_sync_s`` seconds;
    - placement consults the peer filters first and only RPCs what
      the filters cannot rule out, with filter-credited copies
      verified by one pre-ack ``has_chunks`` round.
    """

    enabled: bool = False
    memtable_entries: int = 65536   # bounded in-memory index entries
                                    # before a flush to a sorted run
    compact_runs: int = 4           # sorted runs before a full
                                    # compaction folds them into one
    filter_bits_per_key: int = 10   # peer-filter bloom density;
                                    # 0 = no filters (index only)
    filter_sync_s: float = 5.0      # filter gossip cadence (s);
                                    # 0 = no background exchange
    background_compact: bool = False  # run full compactions on a
                                    # dedicated thread instead of the
                                    # CAS worker that tripped them;
                                    # False = historical inline merge
    echo_cache_entries: int = 0     # per-peer LRU of digests whose
                                    # hash-echo was confirmed this
                                    # session (skips even the pre-ack
                                    # verify round on re-upload);
                                    # 0 = no cache (verify every time)

    def __post_init__(self) -> None:
        if self.memtable_entries < 256:
            raise ValueError("memtable_entries must be >= 256")
        if self.compact_runs < 1:
            raise ValueError("compact_runs must be >= 1")
        if self.filter_bits_per_key < 0:
            raise ValueError("filter_bits_per_key must be >= 0")
        if self.filter_sync_s < 0:
            raise ValueError("filter_sync_s must be >= 0")
        if self.echo_cache_entries < 0:
            raise ValueError("echo_cache_entries must be >= 0")


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """Hot/cold tiering plane (:mod:`dfs_tpu_torch.tier`), a copy of
    dfs_tpu's: temperature-driven demotion of cold files from full
    replication to wide EC stripes, with transparent promotion on
    re-heat.

    Everything defaults off: ``TierConfig()`` builds no ledger, no
    worker and no admission class — reads and repair run the code paths
    they run without the plane. ``enabled=True`` builds the
    :class:`~dfs_tpu_torch.tier.TierPlane`:

    - every served chunk feeds a bounded per-digest temperature ledger
      (last access + read count decayed with ``half_life_s``);
    - classification is by BYTE-BUDGET percentile, not fixed age: the
      hottest files up to ``hot_fraction`` of referenced bytes stay
      replicated, the rest are demotion candidates once idle longer
      than ``min_idle_s``;
    - the demotion worker (every ``scan_interval_s``; 0 = manual
      ``POST /tier`` scans only) EC-encodes cold files at ``ec_k``+2,
      (P+Q on the node's device), flips the manifest/index tier bit,
      then deletes surplus
      replicas — throttled by ``demote_credit_bytes``/s so demotion
      never starves user traffic;
    - a cold read reconstructs transparently (the existing EC decode
      path) and re-materializes a replicated copy once its decayed
      read count crosses ``promote_reads``.
    """

    enabled: bool = False
    hot_fraction: float = 0.1       # fraction of referenced bytes kept
                                    # replicated (the hot set); the
                                    # rest is cold-eligible
    min_idle_s: float = 300.0       # never demote a file read more
                                    # recently than this (absolute
                                    # floor under the percentile)
    scan_interval_s: float = 0.0    # demotion scan cadence (s);
                                    # 0 = manual scans only (POST /tier)
    ec_k: int = 4                   # data shards per cold EC stripe
                                    # (parity is always P+Q = 2)
    demote_credit_bytes: int = 8 * 1024 * 1024  # demotion byte budget
                                    # per second (ByteRate);
                                    # 0 = unthrottled
    half_life_s: float = 3600.0     # read-count decay half-life (s)
    promote_reads: float = 2.0      # decayed reads at which a cold
                                    # file re-materializes replicated
    ledger_entries: int = 65536     # bounded temperature-ledger size
                                    # (LRU beyond it)
    redemote_cooldown_s: float = 0.0  # after a promotion, the file is
                                    # NOT demotion-eligible again for
                                    # this long — hysteresis so a file
                                    # flapping around promote_reads
                                    # doesn't churn encode/decode
                                    # cycles; 0 = eligible immediately

    def __post_init__(self) -> None:
        if not 0.0 <= self.hot_fraction <= 1.0:
            raise ValueError("hot_fraction must be within [0, 1]")
        if self.min_idle_s < 0:
            raise ValueError("min_idle_s must be >= 0")
        if self.scan_interval_s < 0:
            raise ValueError("scan_interval_s must be >= 0")
        if not 1 <= self.ec_k <= 255:
            raise ValueError("ec_k must be within [1, 255]")
        if self.demote_credit_bytes < 0:
            raise ValueError("demote_credit_bytes must be >= 0")
        if self.half_life_s <= 0:
            raise ValueError("half_life_s must be > 0")
        if self.promote_reads < 0:
            raise ValueError("promote_reads must be >= 0")
        if self.ledger_entries < 256:
            raise ValueError("ledger_entries must be >= 256")
        if self.redemote_cooldown_s < 0:
            raise ValueError("redemote_cooldown_s must be >= 0")


@dataclasses.dataclass(frozen=True)
class CensusConfig:
    """Cluster census and capacity plane (:mod:`dfs_tpu_torch.obs.census`,
    :mod:`dfs_tpu_torch.obs.history`), a copy of dfs_tpu's.

    The census is pull-driven (``GET /census`` fans out the internal
    ``get_census`` op and costs nothing until asked); these knobs bound
    the embedded metrics history sampler, a fixed-memory two-resolution
    ring of selected counters and gauges behind ``GET /metrics/history``
    and the doctor's ``capacity_trend`` rule. The defaults keep ~1 h at
    10 s and ~24 h at 5 min per series; ``history_interval_s=0`` turns
    the sampler off (census queries still answer).
    """

    history_interval_s: float = 10.0  # fine-resolution sample period
                                # (s); 0 = the history sampler is off
    history_slots: int = 360    # fine buckets kept per series
    history_coarse_every: int = 30   # fine steps per coarse bucket
    history_coarse_slots: int = 288  # coarse buckets kept
    max_listed: int = 64        # bounded per-category digest lists in
                                # census findings

    def __post_init__(self) -> None:
        if self.history_interval_s < 0:
            raise ValueError("history_interval_s must be >= 0")
        if self.history_slots < 1 or self.history_coarse_slots < 1:
            raise ValueError("history slots must be >= 1")
        if self.history_coarse_every < 1:
            raise ValueError("history_coarse_every must be >= 1")
        if self.max_listed < 1:
            raise ValueError("max_listed must be >= 1")


@dataclasses.dataclass(frozen=True)
class RingConfig:
    """Elastic membership plane (:mod:`dfs_tpu_torch.ring`), a copy of
    dfs_tpu's.

    ``vnodes=0`` (the default) compiles the boot peer list into the
    static epoch-0 ring (cyclic mod-N replica sets); ``vnodes > 0`` runs
    the weighted consistent-hash ring from boot. A live membership change
    (``ring add/remove/drain``) on a static cluster promotes it to hash
    mode at the default vnode count with the epoch bump.

    ``members`` restricts which boot peers own digest space at epoch 0
    ("" = all of them): the other peers of the address book are reachable
    standbys, placed on only after a ``ring add``.

    ``rebalance_credit_bytes`` bounds the online rebalancer: each node
    moves at most this many payload bytes per second to new-epoch owners
    (a token bucket on the repair push and pull paths). 0 = unthrottled.
    """

    vnodes: int = 0             # vnodes per unit weight; 0 = static
    members: str = ""           # csv node ids owning digest space at
                                # epoch 0; "" = every cluster peer
    rebalance_credit_bytes: int = 8 * 1024 * 1024  # rebalance bytes/s
                                # per node; 0 = unthrottled

    def __post_init__(self) -> None:
        if self.vnodes < 0:
            raise ValueError("vnodes must be >= 0")
        if self.rebalance_credit_bytes < 0:
            raise ValueError("rebalance_credit_bytes must be >= 0")
        if not isinstance(self.members, str):
            raise ValueError("members must be a csv string of node ids")
        if self.members and not all(
                p.strip().isdigit() for p in self.members.split(",")):
            raise ValueError(f"members must be a csv of node ids, "
                             f"got {self.members!r}")

    def member_ids(self) -> list[int] | None:
        """Parsed epoch-0 member ids, or None for 'every peer'."""
        if not self.members:
            return None
        return sorted({int(p.strip()) for p in self.members.split(",")})


@dataclasses.dataclass(frozen=True)
class ClientConfig:
    """The smart client's data plane (:mod:`dfs_tpu_torch.client`), a copy
    of dfs_tpu's, field for field.

    The client chunks and hashes locally with the cluster's parameters,
    reads the cluster's ring and peer-existence filters, stripes payloads
    straight to the rf ring owners and commits with one coordinator call.
    Every knob is a ``--client-*`` flag of ``upload``/``download`` and a
    key of ``SmartClient.stats()``. Defaults: striping on, client-side
    hedging off, the legacy fallback on.
    """

    window: int = 2             # upload slices in flight per owner; 1 =
                                # serial slices
    stripe: int = 4             # peers a striped download reads from
                                # concurrently; 1 = effectively serial
    hedge_budget_per_s: float = 0.0  # client hedge token refill per
                                # second; 0 = client-side hedging off
    hedge_floor_s: float = 0.05  # minimum client hedge delay
    hedge_cap_s: float = 1.0    # maximum client hedge delay
    filter_max_age_s: float = 30.0  # peer-existence filters older than
                                # this are refetched before an upload;
                                # 0 = refetch every upload
    echo_cache_entries: int = 4096  # per-peer LRU of digests whose hash
                                # echo this client saw confirmed; 0 = a
                                # verify round on every re-upload
    fallback: bool = True       # degrade to the legacy coordinator path
                                # (old servers, unreachable owners, a
                                # refused commit); False = raise instead

    def __post_init__(self) -> None:
        if self.window < 1:
            raise ValueError("window must be >= 1")
        if self.stripe < 1:
            raise ValueError("stripe must be >= 1")
        if self.hedge_budget_per_s < 0:
            raise ValueError("hedge_budget_per_s must be >= 0")
        if self.hedge_floor_s < 0 or self.hedge_cap_s < self.hedge_floor_s:
            raise ValueError("need 0 <= hedge_floor_s <= hedge_cap_s")
        if self.filter_max_age_s < 0:
            raise ValueError("filter_max_age_s must be >= 0")
        if self.echo_cache_entries < 0:
            raise ValueError("echo_cache_entries must be >= 0")


@dataclasses.dataclass(frozen=True)
class NodeConfig:
    """One node of a port cluster (module docstring)."""

    node_id: int
    cluster: ClusterConfig
    data_root: Path
    fragmenter: str = "auto"        # any name get_fragmenter takes:
                                    # dfs_tpu's, and the -cuda names
    sidecar_port: int | None = None  # delegate chunk+hash to a sidecar
                                     # process (overrides `fragmenter`)
    cdc: CDCParams = dataclasses.field(default_factory=CDCParams)
    frag: FragmenterConfig = dataclasses.field(
        default_factory=FragmenterConfig)
    fixed_parts: int = 5            # the fixed strategy's part count
    connect_timeout_s: float = 2.0
    request_timeout_s: float = 10.0
    retries: int = 3
    health_probe_s: float = 5.0     # 0 = data-path feedback only
    # copies (the local one included) an upload needs before it acks;
    # sloppy-quorum handoff keeps uploads available while any
    # write_quorum nodes are reachable
    write_quorum: int = 2
    ingest: IngestConfig = dataclasses.field(default_factory=IngestConfig)
    # observability: the span ring, the journal and the sentinels are on
    # by default, as in dfs_tpu; ObsConfig(trace_ring=0, journal_bytes=0,
    # sentinel_interval_s=0) turns them off
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    durability: DurabilityConfig = dataclasses.field(
        default_factory=DurabilityConfig)
    # fault injection: the default ChaosConfig() builds no injector
    chaos: ChaosConfig = dataclasses.field(default_factory=ChaosConfig)
    device: str | None = None       # None = the CUDA card; "cpu" = plain
    # similarity plane: the default SimConfig() builds no sketcher, no
    # band index and no delta tree
    sim: SimConfig = dataclasses.field(default_factory=SimConfig)
    # serving tier: the default ServeConfig() builds no cache, no gate
    # and no hedge policy
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    # dedup/index plane: the default IndexConfig() builds no index and no
    # filters — local existence stays one stat, placement probes every
    # digest over RPC
    index: IndexConfig = dataclasses.field(default_factory=IndexConfig)
    # hot/cold tiering plane: the default TierConfig() builds no ledger
    # and no worker
    tier: TierConfig = dataclasses.field(default_factory=TierConfig)
    # elastic membership: the default RingConfig() compiles the boot peer
    # list into the static epoch-0 ring
    ring: RingConfig = dataclasses.field(default_factory=RingConfig)
    # census and capacity plane: the history sampler's bounds and the
    # census finding-list cap
    census: CensusConfig = dataclasses.field(default_factory=CensusConfig)

    @property
    def self_addr(self) -> PeerAddr:
        return self.cluster.peer(self.node_id)

    def to_json(self) -> str:
        """The whole configuration as JSON (nested sections as objects,
        paths as strings), as dfs_tpu's ``NodeConfig.to_json``."""
        def enc(o):
            if dataclasses.is_dataclass(o) and not isinstance(o, type):
                return dataclasses.asdict(o)
            if isinstance(o, Path):
                return str(o)
            raise TypeError(type(o))
        return json.dumps(self, default=enc, indent=2)
