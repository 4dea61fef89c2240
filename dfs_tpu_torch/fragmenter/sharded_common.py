"""Plumbing of the sharded fragmenters (dfs_tpu's ``sharded_common.py``).

- :func:`fixed_region_bytes`: the one window-size policy — every window
  of a stream but the ragged tail has this size.
- :class:`ShardedSteps`: the mesh and the step bundle of a sharded walk.
  **Deviation from dfs_tpu:** there, fewer visible devices than configured
  (or any failure to build) logs a warning and degrades to one device;
  here the mesh is made when the fragmenter is made and raises, so a
  deployment never runs on fewer devices than it was configured for.
"""

from __future__ import annotations

from typing import Callable

from dfs_tpu_torch.parallel.mesh import make_mesh


def fixed_region_bytes(requested: int, default: int, granule: int) -> int:
    """The fixed per-stream window size in bytes: ``requested`` (or
    ``default`` when 0) floored to a whole multiple of ``granule``, never
    below one granule."""
    rb = int(requested) or int(default)
    return max(int(granule), rb // int(granule) * int(granule))


class ShardedSteps:
    """``make_mesh(devices, dp, device)`` now (raises when the devices are
    not there); ``build(mesh)`` once, on the first :meth:`get`."""

    def __init__(self, devices: int, build: Callable, dp: int = 1,
                 device=None) -> None:
        self.mesh = make_mesh(int(devices), dp=int(dp), device=device)
        self._build = build
        self._steps = None

    def get(self):
        if self._steps is None:
            self._steps = self._build(self.mesh)
        return self._steps
