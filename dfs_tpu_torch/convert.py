"""State carried across from ``dfs_tpu``.

The system keeps no weights; its state is (a) the chunking parameters,
which decide every chunk boundary and so every digest, and (b) the data
root on disk.

(a) :func:`params_from_reference` turns a ``dfs_tpu`` anchored
fragmenter's ``describe()`` document (the JSON the resume protocol and the
smart client already exchange) into this package's
:class:`AnchoredCdcParams`, so both engines chunk the same bytes into the
same chunks.

(b) A ``dfs_tpu`` data root needs no conversion. Both packages lay a node
out as ``<data_root>/node-<id>/chunks/<d[:2]>/<digest>`` (raw chunk bytes,
named by their sha256) and ``<data_root>/node-<id>/manifests/<fileId>.json``
(manifest v2 JSON, the same schema and the same serialization), so
:class:`dfs_tpu_torch.node.LocalNode` opens a root that ``dfs_tpu`` wrote
and the other way round. An erasure-coded file's data shards and P/Q
parity are plain chunks of that store, named by their digests, and its
manifest carries the stripe layout (``ec``), so EC files cross as they
are. Chunks stored as similarity deltas
(``<data_root>/node-<id>/chunks/deltas/<d[:2]>/<digest>``, DSD1 blobs) and
the band log (``<data_root>/node-<id>/sim/bands.log``) have one format in
both packages: either package's ``ChunkStore`` reconstructs the other's
deltas and honours their base pins, with or without a sim plane attached.
The digest index (``<data_root>/node-<id>/index/``: the WAL files with
their per-record CRC, the sorted run files with their fences and blooms,
and the ``CURRENT`` manifest) and the tiering plane's temperature ledger
(``<data_root>/node-<id>/tier/ledger.json``) also have one format in both
packages: either package's ``serve --index --tier`` opens the other's, and
a cold file (``tier: "cold"`` in its manifest, EC parity in the store)
reads back and promotes on either kind of node.
"""

from __future__ import annotations

from dfs_tpu_torch.ops.cdc_anchored import AnchoredCdcParams
from dfs_tpu_torch.ops.cdc_v2 import AlignedCdcParams


def params_from_reference(describe: dict) -> AnchoredCdcParams:
    """AnchoredCdcParams from an anchored fragmenter's ``describe()``."""
    if describe.get("kind") != "cdc-anchored":
        raise ValueError(f"not an anchored description: "
                         f"{describe.get('kind')!r}")
    c = describe["chunk"]
    return AnchoredCdcParams(
        chunk=AlignedCdcParams(min_blocks=int(c["min_blocks"]),
                               avg_blocks=int(c["avg_blocks"]),
                               max_blocks=int(c["max_blocks"]),
                               strip_blocks=int(c["strip_blocks"]),
                               seed=int(c["seed"])),
        seg_min=int(describe["seg_min"]), seg_max=int(describe["seg_max"]),
        seg_mask=int(describe["seg_mask"]), seed=int(describe["seed"]))
