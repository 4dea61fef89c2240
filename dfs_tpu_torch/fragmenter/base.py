"""The Fragmenter interface: a strategy that splits a byte stream into
content-addressed chunks. The node calls ``manifest`` / ``manifest_stream``
and gets chunk metadata back; everything downstream (CAS, manifest,
download, dedup) is strategy-agnostic."""

from __future__ import annotations

import abc

from dfs_tpu_torch.meta.manifest import ChunkRef, Manifest
from dfs_tpu_torch.ops.cdc_v2 import file_id_from_digests
from dfs_tpu_torch.utils.hashing import sha256_hex


class Fragmenter(abc.ABC):
    """Splits a byte stream into content-addressed chunks."""

    name: str = "abstract"

    @abc.abstractmethod
    def chunk(self, data: bytes) -> list[ChunkRef]:
        """The chunk list covering ``data`` exactly, in order, with
        per-chunk sha256 digests."""

    @abc.abstractmethod
    def chunks_stream(self, blocks, store=None):
        """Generator of ChunkRef batches in stream order, yielded as the
        block stream is consumed; ``store(digest, payload)`` is called for
        every chunk."""

    @abc.abstractmethod
    def stream_span(self) -> int | None:
        """Upper bound on how far chunks_stream's reporting can lag the
        bytes it has consumed (None = unbounded)."""

    def describe(self) -> dict:
        """A JSON-able description from which another process rebuilds
        this fragmenter's chunk boundaries bit-exactly (the resumable
        upload and the smart client chunk with it); kinds map back through
        :func:`fragmenter_from_description`. Subclasses override."""
        raise NotImplementedError(f"{self.name} is not resume-describable")

    def manifest(self, data: bytes, name: str,
                 file_id: str | None = None) -> Manifest:
        """The manifest for ``data``. Without ``file_id`` the id is derived
        from the chunk digests, as :meth:`manifest_stream` derives it (a
        node that needs fileId = sha256(body) passes it)."""
        chunks = tuple(self.chunk(data))
        return Manifest(
            file_id=file_id or file_id_from_digests(
                [c.digest for c in chunks]),
            name=name, size=len(data), fragmenter=self.name, chunks=chunks)

    def manifest_stream(self, blocks, name: str, store=None) -> Manifest:
        """Drain :meth:`chunks_stream`: size = last chunk end, file_id
        derived from the digests."""
        chunks: list[ChunkRef] = []
        for batch in self.chunks_stream(blocks, store=store):
            chunks.extend(batch)
        size = chunks[-1].offset + chunks[-1].length if chunks else 0
        return Manifest(
            file_id=file_id_from_digests([c.digest for c in chunks]),
            name=name, size=size, fragmenter=self.name,
            chunks=tuple(chunks))


class MaterializingFragmenter(Fragmenter):
    """A strategy with dfs_tpu's base-class manifests and streaming:
    ``fileId = sha256(data)`` unless given; the blocks are joined and
    chunked whole (``fixed`` needs the total size for its split), so the
    reporting lag is unbounded and :meth:`stream_span` is None — a sidecar
    advertises ``window`` 0. Subclasses with a streaming walk override
    :meth:`manifest_stream`."""

    def stream_span(self) -> int | None:
        return None

    def manifest(self, data: bytes, name: str,
                 file_id: str | None = None) -> Manifest:
        return Manifest(file_id=file_id or sha256_hex(data), name=name,
                        size=len(data), fragmenter=self.name,
                        chunks=tuple(self.chunk(data)))

    def manifest_stream(self, blocks, name: str, store=None) -> Manifest:
        data = b"".join(blocks)
        m = self.manifest(data, name=name)
        if store is not None:
            for c in m.chunks:
                store(c.digest, data[c.offset:c.offset + c.length])
        return m

    def chunks_stream(self, blocks, store=None):
        data = b"".join(blocks)
        chunks = self.chunk(data)
        if store is not None:
            for c in chunks:
                store(c.digest, data[c.offset:c.offset + c.length])
        if chunks:
            yield chunks


def _aligned_from_cdc(cdc_params):
    """CDCParams byte sizes -> 64-byte block units (quantized), the strip
    grown to hold one max-size chunk — dfs_tpu's ``_aligned_from_cdc``."""
    from dfs_tpu_torch.ops.cdc_v2 import AlignedCdcParams

    max_blocks = max(1, cdc_params.max_size // 64)
    strip_blocks = AlignedCdcParams.__dataclass_fields__[
        "strip_blocks"].default
    while strip_blocks < max_blocks:
        strip_blocks *= 2
    return AlignedCdcParams(
        min_blocks=max(1, cdc_params.min_size // 64),
        avg_blocks=max(1, cdc_params.avg_size // 64),
        max_blocks=max_blocks,
        strip_blocks=strip_blocks)


def _anchored_params(cdc_params):
    """The anchored parameters for a node's chunk sizing — dfs_tpu's
    ``_anchored_params``: seg_max is one lane (the strip's bytes) and
    seg_min keeps the default 3:4 ratio, tile-aligned. The default
    CDCParams() maps to AnchoredCdcParams(), so a port node and a dfs_tpu
    node started with the same flags cut the same chunks."""
    from dfs_tpu_torch.ops.cdc_anchored import TILE_BYTES, AnchoredCdcParams

    if isinstance(cdc_params, AnchoredCdcParams):
        return cdc_params
    if cdc_params is None:
        return AnchoredCdcParams()
    chunk = _aligned_from_cdc(cdc_params)
    seg_max = chunk.strip_blocks * 64
    seg_min = max(TILE_BYTES, (3 * seg_max // 4) // TILE_BYTES * TILE_BYTES)
    return AnchoredCdcParams(chunk=chunk, seg_min=seg_min, seg_max=seg_max)


def _aligned_params(cdc_params):
    """The aligned engines' parameters: given as such, converted from a
    node's byte sizes, or the defaults."""
    from dfs_tpu_torch.ops.cdc_v2 import AlignedCdcParams

    if isinstance(cdc_params, AlignedCdcParams):
        return cdc_params
    return AlignedCdcParams() if cdc_params is None \
        else _aligned_from_cdc(cdc_params)


def get_fragmenter(kind: str, *, cdc_params=None, frag=None,
                   device=None, fixed_parts: int = 5) -> Fragmenter:
    """Factory keyed by ``NodeConfig.fragmenter``; it takes every name of
    dfs_tpu's, and a ``-tpu`` name gives the port's engine on the card
    (``-cuda``, the name its manifests record). ``device`` (None: the CUDA
    card; "cpu": the plain versions) is where the device engines run.

    - ``"auto"``, ``"cdc-anchored-cuda"`` / ``-tpu``: the anchored chain,
      :class:`AnchoredCudaFragmenter`, or with ``frag.devices > 1`` the
      window-batched :class:`ShardedAnchoredCudaFragmenter`. Unlike
      dfs_tpu's ``auto``, never the CPU by itself: without CUDA it raises
      unless ``device="cpu"`` was asked for.
    - ``"cdc-anchored"``: the host engine (the C++ core), or with
      ``frag.devices > 1`` the sharded anchored walk, as in dfs_tpu.
    - ``"fixed"`` (``fixed_parts`` parts), ``"cdc"`` (the Gear rolling hash
      at ``cdc_params``, on the host; with ``frag.devices > 1``
      :class:`ShardedCdcFragmenter` over that many slots of ``device``).
    - ``"cdc-aligned"`` (NumPy) and ``"cdc-aligned-cuda"`` / ``-tpu``
      (kernels 3 and 1): aligned CDC v2.
    - ``"cdc-cuda"`` / ``"cdc-tpu"``: the v1 rolling pipeline on the card,
      with dfs_tpu's DeprecationWarning."""
    if kind == "fixed":
        from dfs_tpu_torch.fragmenter.fixed import FixedFragmenter

        return FixedFragmenter(parts=fixed_parts)
    sharded = frag is not None and frag.devices > 1
    if kind in ("cdc", "cdc-cuda", "cdc-tpu"):
        from dfs_tpu_torch.config import CDCParams

        params = cdc_params or CDCParams()
        if kind != "cdc":
            import warnings

            from dfs_tpu_torch.fragmenter.cdc_cuda import CudaCdcFragmenter

            warnings.warn(
                f"the v1 {kind!r} fragmenter pulls the full candidate "
                "bitmap to the host; it is kept as a byte-granular "
                "compatibility path only (use 'cdc-anchored-cuda')",
                DeprecationWarning, stacklevel=2)
            return CudaCdcFragmenter(params, device=device)
        if sharded:
            from dfs_tpu_torch.fragmenter.cdc_sharded import \
                ShardedCdcFragmenter

            return ShardedCdcFragmenter(params, frag, device=device)
        from dfs_tpu_torch.fragmenter.cdc_cpu import CpuCdcFragmenter

        return CpuCdcFragmenter(params)
    if kind in ("cdc-aligned", "cdc-aligned-cuda", "cdc-aligned-tpu"):
        from dfs_tpu_torch.fragmenter.cdc_aligned import (
            AlignedCpuFragmenter, AlignedCudaFragmenter)

        if kind == "cdc-aligned":
            return AlignedCpuFragmenter(_aligned_params(cdc_params))
        return AlignedCudaFragmenter(_aligned_params(cdc_params),
                                     device=device)
    if kind not in ("auto", "cdc-anchored", "cdc-anchored-cuda",
                    "cdc-anchored-tpu"):
        raise ValueError(f"unknown fragmenter {kind!r}")
    params = _anchored_params(cdc_params)
    if sharded:
        from dfs_tpu_torch.fragmenter.cdc_anchored_sharded import \
            ShardedAnchoredCudaFragmenter

        return ShardedAnchoredCudaFragmenter(params, frag, device=device)
    from dfs_tpu_torch.fragmenter.cdc_anchored import (AnchoredCpuFragmenter,
                                                       AnchoredCudaFragmenter)

    if kind == "cdc-anchored":
        return AnchoredCpuFragmenter(params)
    return AnchoredCudaFragmenter(params, device=device)


def params_from_description(desc: dict):
    """The parameters a ``describe()`` output names, built without
    touching a device: :class:`AnchoredCdcParams` for ``cdc-anchored``,
    :class:`CDCParams` for ``cdc``, the part count for ``fixed``. Any
    other kind raises ValueError; a missing field raises KeyError."""
    kind = desc.get("kind")
    if kind == "fixed":
        return int(desc["parts"])
    if kind == "cdc":
        from dfs_tpu_torch.config import CDCParams

        return CDCParams(min_size=int(desc["min_size"]),
                         avg_size=int(desc["avg_size"]),
                         max_size=int(desc["max_size"]),
                         seed=int(desc["seed"]))
    if kind == "cdc-anchored":
        from dfs_tpu_torch.ops.cdc_anchored import AnchoredCdcParams
        from dfs_tpu_torch.ops.cdc_v2 import AlignedCdcParams

        c = desc["chunk"]
        return AnchoredCdcParams(
            chunk=AlignedCdcParams(
                min_blocks=int(c["min_blocks"]),
                avg_blocks=int(c["avg_blocks"]),
                max_blocks=int(c["max_blocks"]),
                strip_blocks=int(c["strip_blocks"]),
                seed=int(c["seed"])),
            seg_min=int(desc["seg_min"]), seg_max=int(desc["seg_max"]),
            seg_mask=int(desc["seg_mask"]), seed=int(desc["seed"]))
    raise ValueError(f"undescribable fragmenter kind {kind!r}")


def fragmenter_from_description(desc: dict, device=None) -> Fragmenter:
    """Rebuild a chunk-compatible fragmenter from ``describe()`` output —
    dfs_tpu's counterpart; the chunk table equals the describing engine's
    byte for byte, whichever package described it. An anchored
    description gives :class:`AnchoredCudaFragmenter` on ``device``
    (None: the CUDA card, raising without one; "cpu": the plain
    versions); ``fixed`` and ``cdc`` give the host strategies, which need
    no device. Other kinds raise as :func:`params_from_description`
    does."""
    params = params_from_description(desc)
    if desc["kind"] == "fixed":
        from dfs_tpu_torch.fragmenter.fixed import FixedFragmenter

        return FixedFragmenter(parts=params)
    if desc["kind"] == "cdc":
        from dfs_tpu_torch.fragmenter.cdc_cpu import CpuCdcFragmenter

        return CpuCdcFragmenter(params)
    from dfs_tpu_torch.fragmenter.cdc_anchored import AnchoredCudaFragmenter

    return AnchoredCudaFragmenter(params, device=device)
