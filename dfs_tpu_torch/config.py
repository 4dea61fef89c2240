"""Typed configuration of the port: a copy of the parts of dfs_tpu's
``config.py`` that a default node honours.

- :class:`CDCParams` — operator chunk sizing (``--min/avg/max-chunk``);
  ``fragmenter.base._anchored_params`` maps it onto the anchored grid
  exactly as dfs_tpu does, so the same flags cut the same chunks.
- :class:`PeerAddr`, :class:`ClusterConfig` — membership and replication.
- :class:`FragmenterConfig` — how the chunk-and-hash chain runs.
- :class:`IngestConfig` — the pipelined write path's bounds.
- :class:`DurabilityConfig` — fsync before the ack, or not.
- :class:`NodeConfig` — one node. It holds only the fields the port's
  runtime honours; dfs_tpu's default-off planes (serve tier, index, tier,
  sim, chaos, elastic ring, census history, journal) are absent, not
  accepted and ignored. ``device`` is the port's own: ``None`` means the
  CUDA card (raising without one), ``"cpu"`` the plain versions.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class CDCParams:
    """Content-defined-chunking sizes in bytes (``avg_size`` a power of
    two). The anchored strategy quantizes them to its 64-byte grid."""

    min_size: int = 2048
    avg_size: int = 8192
    max_size: int = 65536

    def __post_init__(self) -> None:
        if self.avg_size & (self.avg_size - 1):
            raise ValueError(
                f"avg_size must be a power of two, got {self.avg_size}")
        if not (0 < self.min_size <= self.avg_size <= self.max_size):
            raise ValueError(
                f"need 0 < min ({self.min_size}) <= avg ({self.avg_size})"
                f" <= max ({self.max_size})")


@dataclasses.dataclass(frozen=True)
class PeerAddr:
    """One node's addresses: the external HTTP port and the binary
    storage-plane port."""

    node_id: int
    host: str
    port: int           # external HTTP API port
    internal_port: int  # binary storage-plane port


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
    per slot, chunk tables byte-identical to the single-device walk. With
    fewer devices visible than configured the walk raises (dfs_tpu logs
    and runs single-device instead)."""

    devices: int = 0        # 0/1 = single-device walk; N > 1 = N slots
    region_bytes: int = 0   # fixed window size of the sharded walk;
                            # 0 = 64 MiB split across the window batch
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
class NodeConfig:
    """One node of a port cluster (module docstring)."""

    node_id: int
    cluster: ClusterConfig
    data_root: Path
    fragmenter: str = "auto"        # "auto" | "cdc-anchored-cuda"
    cdc: CDCParams = dataclasses.field(default_factory=CDCParams)
    frag: FragmenterConfig = dataclasses.field(
        default_factory=FragmenterConfig)
    connect_timeout_s: float = 2.0
    request_timeout_s: float = 10.0
    retries: int = 3
    health_probe_s: float = 5.0     # 0 = data-path feedback only
    # copies (the local one included) an upload needs before it acks;
    # sloppy-quorum handoff keeps uploads available while any
    # write_quorum nodes are reachable
    write_quorum: int = 2
    ingest: IngestConfig = dataclasses.field(default_factory=IngestConfig)
    durability: DurabilityConfig = dataclasses.field(
        default_factory=DurabilityConfig)
    device: str | None = None       # None = the CUDA card; "cpu" = plain

    @property
    def self_addr(self) -> PeerAddr:
        return self.cluster.peer(self.node_id)
