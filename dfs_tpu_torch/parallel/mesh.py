"""The device mesh of the multi-device steps: a ``(dp, sp)`` grid of
device slots, the counterpart of dfs_tpu's ``jax.sharding.Mesh``.

A slot is a ``torch.device`` plus, on a card, a CUDA stream of its own,
so slots that share one card still run concurrently on it. Nothing on the
data path is a collective: the JAX steps exchange only a ``psum`` of a
count, which here is a plain sum over the slots' outputs, so the mesh
needs no ``torch.distributed``.

- ``device=None``: one slot per visible card, the first ``n_devices``
  cards; asking for more cards than are visible raises.
- ``device="cpu"`` (or any single device): ``n_devices`` slots on it —
  the CPU mesh the tests use, as dfs_tpu's tests use 8 virtual CPU
  devices.
- an explicit list of devices: those slots, in order; a card may repeat
  (four slots on one H100 rehearse a four-card mesh).
"""

from __future__ import annotations

import dataclasses

import torch

from dfs_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """``devices[dp][sp]`` slots; ``streams`` holds one CUDA stream per
    slot in row-major order (None for a CPU slot)."""
    devices: tuple[tuple[torch.device, ...], ...]
    streams: tuple

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": len(self.devices), "sp": len(self.devices[0])}

    @property
    def flat(self) -> list[torch.device]:
        """The slots in row-major order (slot index = dp * sp_size + sp)."""
        return [d for row in self.devices for d in row]

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])


def _slot_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        if index >= torch.cuda.device_count():
            raise ValueError(f"{dev}: only {torch.cuda.device_count()} "
                             "CUDA devices are visible")
        dev = torch.device("cuda", index)
    return dev


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              device=None) -> DeviceMesh:
    """Mesh with axes ('dp', 'sp') over ``n_devices`` slots (see the
    module docstring for ``device``). ``dp`` defaults to 2 when the slot
    count is even and > 1, else 1."""
    if device is None:
        resolve_device("cuda")               # raises without CUDA
        visible = torch.cuda.device_count()
        n = n_devices or visible
        if n > visible:
            raise ValueError(f"asked for {n} CUDA devices, {visible} "
                             "visible")
        devs = [torch.device("cuda", i) for i in range(n)]
    elif isinstance(device, (list, tuple)):
        devs = [_slot_device(d) for d in device]
        n = n_devices or len(devs)
        if n > len(devs):
            raise ValueError(f"asked for {n} slots, {len(devs)} given")
        devs = devs[:n]
    else:
        n = n_devices or 1
        devs = [_slot_device(device)] * n
    if n < 1:
        raise ValueError("a mesh needs at least one slot")
    if dp is None:
        dp = 2 if n % 2 == 0 and n > 1 else 1
    if n % dp:
        raise ValueError(f"dp={dp} does not divide n={n}")
    sp = n // dp
    grid = tuple(tuple(devs[r * sp:(r + 1) * sp]) for r in range(dp))
    streams = tuple(torch.cuda.Stream(device=d) if d.type == "cuda" else None
                    for d in devs)
    return DeviceMesh(grid, streams)
