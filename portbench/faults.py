"""A storage node with a fault planted under the timed path, for the
benchmark's control and its fault tests (the benchmark's own runs never
start it):

    python portbench/faults.py <fault> serve <serve flags>

- ``rf1``: the control; every chunk is placed once, so the configuration's
  replication guarantee is broken (the address book read with replication
  1, and ``--write-quorum 1`` after the configuration's flags);
- ``unchanged``: placement returns at once, leaving the store as it was;
- ``half_batch``: placement takes only the first half of each batch;
- ``altered``: one digest of each region's chunk table is altered where
  the chain produces it.
"""

from __future__ import annotations

import sys
from pathlib import Path


def plant(fault: str, argv: list[str]) -> list[str]:
    if fault == "rf1":
        import dataclasses

        from dfs_tpu_torch.config import ClusterConfig

        read = ClusterConfig.from_file
        ClusterConfig.from_file = staticmethod(
            lambda path: dataclasses.replace(read(path),
                                             replication_factor=1))
        return argv + ["--write-quorum", "1"]
    if fault in ("unchanged", "half_batch"):
        from dfs_tpu_torch.node.runtime import StorageNodeServer

        place = StorageNodeServer._place_batch

        async def broken(self, file_id, batch, stats, **kw):
            if fault == "unchanged":
                return None
            return await place(self, file_id, batch[:len(batch) // 2],
                               stats, **kw)

        StorageNodeServer._place_batch = broken
        return argv
    if fault == "altered":
        from dfs_tpu_torch.fragmenter import cdc_anchored

        collect = cdc_anchored.region_collect

        def broken(out):
            spans, consumed = collect(out)
            if spans:
                o, ln, dg = spans[0]
                spans = [(o, ln, dg[:-1] + ("0" if dg[-1] != "0" else "1"))
                         ] + list(spans[1:])
            return spans, consumed

        cdc_anchored.region_collect = broken
        oracle = cdc_anchored.chunk_file_anchored_np

        def broken_small(data, params):
            # streams below the walk's cut-off are chunked by this instead
            table = oracle(data, params)
            if table:
                o, ln, dg = table[0]
                table[0] = (o, ln, dg[:-1] + ("0" if dg[-1] != "0" else "1"))
            return table

        cdc_anchored.chunk_file_anchored_np = broken_small
        return argv
    raise SystemExit(f"unknown fault {fault!r}")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    args = plant(sys.argv[1], sys.argv[2:])
    from dfs_tpu_torch.cli.main import main

    sys.exit(main(args))
