"""One sharded program across processes — dfs_tpu's
``parallel/multihost.py``.

dfs_tpu joins processes into one JAX runtime (``jax.distributed``) and
shards its steps over the global device mesh. Here every process joins a
``torch.distributed`` group over gloo (``tcp://`` rendezvous at the
coordinator) and brings its own device slots; :func:`global_mesh` lays all
slots out as one ``(dp, sp)`` grid, each process's slots contiguous along
sp, as dfs_tpu keeps each host's devices. The steps of
``parallel.sharded_cdc`` that take a :class:`GlobalMesh`
(``make_sharded_step``, ``make_sharded_bitmap_step``,
``make_anchored_step``) run only this process's slots, exchange the 31-word
Gear halo with a neighbour slot of another process over gloo, sum the
count with ``all_reduce``, and return this process's slots' outputs.

The cross-process legs are tiny (a halo a row, one count), so they go over
gloo on host copies whatever the slots are: NCCL refuses two ranks on one
card, and a machine with one card runs both processes' slots on it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from dfs_tpu_torch.parallel.mesh import DeviceMesh, make_mesh


def init_multihost(coordinator: str, num_processes: int,
                   process_id: int) -> None:
    """Join this process into the group: ``coordinator`` is "host:port"
    of a free port on process 0's host. Single-process callers skip
    this."""
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))


@dataclasses.dataclass(frozen=True)
class GlobalMesh:
    """A ``(dp, sp)`` grid over the slots of every process. ``owners[g]``
    is the process of global slot ``g`` (row-major); ``local`` holds this
    process's slots, in global order."""
    dims: tuple[int, int]
    owners: tuple[int, ...]
    process_index: int
    local: DeviceMesh

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.dims[0], "sp": self.dims[1]}

    @property
    def size(self) -> int:
        return self.dims[0] * self.dims[1]

    @property
    def local_slots(self) -> tuple[int, ...]:
        return tuple(g for g, p in enumerate(self.owners)
                     if p == self.process_index)


def global_mesh(dp: int | None = None, devices=None) -> GlobalMesh:
    """The global mesh after :func:`init_multihost`. ``devices`` are this
    process's slots, as ``make_mesh`` takes them (None: one per visible
    card; a list: those slots, a card may repeat). ``dp`` defaults to 2
    when the global slot count is even and > 1."""
    if isinstance(devices, (list, tuple)):
        local = make_mesh(len(devices), dp=1, device=list(devices))
    else:
        local = make_mesh(None, dp=1, device=devices)
    counts: list = [None] * dist.get_world_size()
    dist.all_gather_object(counts, local.size)
    owners = tuple(p for p, c in enumerate(counts) for _ in range(c))
    n = len(owners)
    if dp is None:
        dp = 2 if n % 2 == 0 and n > 1 else 1
    if n % dp:
        raise ValueError(f"dp={dp} does not divide global slot count {n}")
    return GlobalMesh((dp, n // dp), owners, dist.get_rank(), local)


def process_info(mesh: GlobalMesh | None = None) -> dict:
    """dfs_tpu's four keys. The slot counts are ``mesh``'s, or the visible
    cards of every process without one."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh is not None:
        local, total = mesh.local.size, mesh.size
    else:
        local = torch.cuda.device_count()
        total = local
        if dist.is_initialized():
            counts: list = [None] * world
            dist.all_gather_object(counts, local)
            total = sum(counts)
    return {"process_index": rank, "process_count": world,
            "local_devices": local, "global_devices": total}


def multihost_parity_check(devices, cols: int = 2048) -> dict:
    """After :func:`init_multihost` with 2 processes, each bringing the
    slots ``devices`` (two of them): the rolling step, the carry bitmap
    step and the anchored pass B over the global mesh at dp 1 (sp spans
    both processes, so the halo crosses over gloo) and dp 2, this
    process's slots held to the NumPy oracles and the all-reduced counts
    to the whole input's (the check of dfs_tpu's
    ``tests/test_multihost.py``). Raises AssertionError on a mismatch;
    returns what was checked."""
    import hashlib

    import numpy as np

    from dfs_tpu_torch.config import CDCParams
    from dfs_tpu_torch.fragmenter.cdc_cpu import gear_bitmap_numpy
    from dfs_tpu_torch.ops.cdc_anchored import (AnchoredCdcParams,
                                                region_buffer)
    from dfs_tpu_torch.ops.cdc_v2 import AlignedCdcParams
    from dfs_tpu_torch.ops.sha256 import pad_messages, state_to_hex
    from dfs_tpu_torch.parallel import sharded_cdc as S
    from dfs_tpu_torch.utils.hashing import gear_table

    def need(cond: bool, what: str) -> None:
        if not cond:
            raise AssertionError(f"multihost: {what}")

    params = CDCParams(min_size=64, avg_size=256, max_size=1024)
    table = gear_table(params.seed)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=(2, cols), dtype=np.uint8)
    msgs = [rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()
            for n in rng.integers(0, 200, size=8)]
    words, nblocks = pad_messages(msgs, n_blocks=4, batch=8)
    head = table[rng.integers(0, 256, size=(2, 31))].astype(np.uint32)
    whole = np.stack([gear_bitmap_numpy(r, table, params.mask) for r in data])
    carried = np.stack([gear_bitmap_numpy(r, table, params.mask, h)
                        for r, h in zip(data, head)])
    digests = [hashlib.sha256(m).hexdigest() for m in msgs]
    out: dict = {}
    for dp in (1, 2):
        mesh = global_mesh(dp=dp, devices=devices)
        need(process_info(mesh)["global_devices"] == 4 and mesh.size == 4,
             f"global mesh {mesh.dims}")
        sp = mesh.shape["sp"]
        rows, width = data.shape[0] // dp, data.shape[1] // sp

        def piece(full, g):
            r, c = divmod(g, sp)
            return full[r * rows:(r + 1) * rows, c * width:(c + 1) * width]

        bitmap, states, count = S.make_sharded_step(
            mesh, table, params.mask)(*S.shard_inputs(mesh, data, words,
                                                      nblocks))
        carry = S.make_sharded_bitmap_step(mesh, table, params.mask)(
            *S.shard_bitmap_inputs(mesh, data, head))
        for g, b, st, cb in zip(mesh.local_slots, bitmap, states, carry):
            need(np.array_equal(b.cpu().numpy(), piece(whole, g)),
                 f"dp {dp} slot {g} bitmap")
            need(state_to_hex(st) == digests[2 * g:2 * g + 2],
                 f"dp {dp} slot {g} states")
            need(np.array_equal(cb.cpu().numpy(), piece(carried, g)),
                 f"dp {dp} slot {g} carry bitmap")
        need(int(count) == int(whole.sum()), f"dp {dp} count")
        out[f"dp{dp}"] = {"slots": list(mesh.local_slots),
                          "candidates": int(count)}

    aparams = AnchoredCdcParams(
        chunk=AlignedCdcParams(min_blocks=2, avg_blocks=4, max_blocks=16,
                               strip_blocks=64),
        seg_min=2048, seg_max=4096, seg_mask=2047)
    adata = np.random.default_rng(77).integers(0, 256, size=64 * 1024,
                                               dtype=np.uint8)
    awords = np.asarray(region_buffer(adata, np.zeros((8,), np.uint8),
                                      aparams))
    mesh = global_mesh(dp=2, devices=devices)
    starts, bounds, _, w_off, sh8, rb, s_real = S.host_lane_descriptors(
        adata, aparams, mesh.size)
    expect = S.expected_segment_cutflags(adata, starts, bounds, aparams)
    cf, _, _, n_chunks = S.make_anchored_step(mesh, aparams)(
        *S.shard_anchored_inputs(mesh, awords, w_off, sh8, rb))
    lanes = w_off.shape[0] // mesh.size
    for g, local in zip(mesh.local_slots, cf):
        local = local.cpu().numpy()
        for j, lane in enumerate(range(g * lanes, (g + 1) * lanes)):
            want = expect[:, lane] if lane < s_real else 0 * local[:, j]
            need(np.array_equal(local[:, j], want), f"anchored lane {lane}")
    need(int(n_chunks) == int(expect.sum()) > 0, "anchored chunk count")
    out["anchored"] = {"lanes": int(w_off.shape[0]), "segments": int(s_real),
                       "chunks": int(n_chunks)}
    return out
