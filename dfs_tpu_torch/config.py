"""Execution knobs of the fragmenter (a copy of dfs_tpu's
``FragmenterConfig``): *how* the chunk-and-hash chain runs — over how
many devices, in which window size, with how much staging — never *what*
it computes. Chunk tables are identical for every setting."""

from __future__ import annotations

import dataclasses


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
