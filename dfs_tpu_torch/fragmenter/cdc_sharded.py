"""The rolling ``cdc`` strategy over several device slots — dfs_tpu's
``fragmenter/cdc_sharded.py`` (``cdc`` with ``--cdc-devices N``).

:class:`ShardedCdcFragmenter` is :class:`CpuCdcFragmenter` with one
substitution: the streaming walk's bitmap kernel runs each region through
``parallel.sharded_cdc.make_sharded_bitmap_step``, the windowed Gear bitmap
tiled over the slots along sp, each slot taking its left neighbour's last
31 Gear values and sp-slot 0 the stream's carry. Greedy cut selection,
hashing, manifests and ``describe()`` are inherited, so the chunks equal
the host engine's byte for byte.

The stream is re-blocked to a fixed region size (``FragmenterConfig.
region_bytes``, by default ``devices`` MiB, floored to a multiple of
``devices`` and at least ``devices * 4 * 31`` bytes), so every slot gets an
equal span; the ragged final region takes the host kernel, dfs_tpu's shape
policy. **Deviation from dfs_tpu:** with fewer devices than configured the
mesh raises when the fragmenter is made (dfs_tpu logs and chunks on the
host), as the port's other sharded walks do.
"""

from __future__ import annotations

import numpy as np

from dfs_tpu_torch.config import GEAR_HALO as HALO
from dfs_tpu_torch.config import CDCParams, FragmenterConfig
from dfs_tpu_torch.fragmenter.cdc_cpu import CpuCdcFragmenter
from dfs_tpu_torch.fragmenter.sharded_common import (ShardedSteps,
                                                     fixed_region_bytes)
from dfs_tpu_torch.meta.manifest import Manifest


class ShardedCdcFragmenter(CpuCdcFragmenter):
    """CpuCdcFragmenter whose streaming bitmap is sharded over device slots
    (``device`` as ``make_mesh`` takes it: None, one slot per card; "cpu";
    or a list of slots). Same ``name`` and ``describe()`` as the host
    engine: manifests record the strategy, whose output is identical."""

    def __init__(self, params: CDCParams | None = None,
                 frag: FragmenterConfig | None = None, device=None) -> None:
        super().__init__(params)
        frag = frag or FragmenterConfig(devices=2)
        self.devices = max(2, int(frag.devices))
        # every slot's span equal and long enough to source the 31-value
        # halo of its right neighbour from its own bytes
        self.region_bytes = max(
            self.devices * 4 * HALO,
            fixed_region_bytes(frag.region_bytes,
                               self.devices * (1 << 20), self.devices))
        self._steps = ShardedSteps(self.devices, self._build, device=device)

    @property
    def mesh(self):
        return self._steps.mesh

    def _build(self, mesh):
        from dfs_tpu_torch.parallel.sharded_cdc import \
            make_sharded_bitmap_step

        return make_sharded_bitmap_step(mesh, self.table, self.params.mask)

    def bitmap_tile(self, arr: np.ndarray,
                    prev_g: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        if arr.shape[0] != self.region_bytes:
            # the ragged final region: the host kernel computes the same
            # bitmap from the same halo
            return super().bitmap_tile(arr, prev_g)
        from dfs_tpu_torch.parallel.sharded_cdc import shard_bitmap_inputs

        step = self._steps.get()
        data, head = shard_bitmap_inputs(
            self.mesh, np.ascontiguousarray(arr)[None, :],
            np.ascontiguousarray(prev_g)[None, :])
        bitmap = step(data, head)[0].cpu().numpy()
        # the next region's halo: the Gear values of the last 31 bytes
        return bitmap, self.table[arr[-HALO:]].astype(np.uint32)

    def manifest_stream(self, blocks, name: str, store=None) -> Manifest:
        from dfs_tpu_torch.fragmenter.stream import (manifest_from_stream,
                                                     reblock)

        return manifest_from_stream(
            reblock(blocks, self.region_bytes), self.params,
            self.bitmap_tile, name, self.name, store)
