"""The frozen reference equals the port's plain path (``device="cpu"``) at
tiny geometries, and derives the same parameters from a node's chunk
sizes. This test imports both; the reference itself imports nothing of
the port."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from portbench.reference import anchored

SIZINGS = [(2048, 8192, 65536),             # the port's default
           (524288, 1048576, 8388608),      # restic's
           (256, 1024, 8192),               # a small grid
           (4096, 4096, 4096)]              # min == avg == max


@pytest.mark.parametrize("sizing", SIZINGS)
def test_parameters_match_the_nodes_mapping(sizing):
    from dfs_tpu_torch.config import CDCParams
    from dfs_tpu_torch.fragmenter.base import _anchored_params

    p = _anchored_params(CDCParams(*sizing))
    r = anchored.params_for(*sizing)
    assert (r.min_blocks, r.avg_blocks, r.max_blocks, r.strip_blocks,
            r.seg_min, r.seg_max, r.seg_mask, r.seed, r.gear_seed) == (
        p.chunk.min_blocks, p.chunk.avg_blocks, p.chunk.max_blocks,
        p.chunk.strip_blocks, p.seg_min, p.seg_max, p.seg_mask, p.seed,
        p.chunk.seed)


@pytest.mark.parametrize("seed,n", [(1, 700_001), (2, 1 << 20),
                                    (3, 393_216 + 17)])
def test_reference_equals_the_ports_plain_walk(seed, n):
    from dfs_tpu_torch.config import CDCParams
    from dfs_tpu_torch.fragmenter.base import _anchored_params
    from dfs_tpu_torch.fragmenter.cdc_anchored import AnchoredCudaFragmenter

    sizing = (256, 1024, 8192)
    data = np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)
    # a run of zeros: no anchors, forced segment ends
    data[n // 3:n // 3 + 200_000] = 0
    frag = AnchoredCudaFragmenter(_anchored_params(CDCParams(*sizing)),
                                  region_bytes=512 * 1024, cpu_cutoff=0,
                                  device="cpu")
    got = [(c.offset, c.length, c.digest) for c in frag.chunk(data)]
    assert got == anchored.chunk_table(data, anchored.params_for(*sizing))


def test_reference_equals_the_ports_oracle_at_the_default_sizing():
    from dfs_tpu_torch.config import CDCParams
    from dfs_tpu_torch.fragmenter.base import _anchored_params
    from dfs_tpu_torch.ops.cdc_anchored import chunk_file_anchored_np

    data = np.random.default_rng(9).integers(0, 256, 3 << 20,
                                             dtype=np.uint8)
    want = chunk_file_anchored_np(data, _anchored_params(CDCParams()))
    assert anchored.chunk_table(data, anchored.params_for(
        2048, 8192, 65536)) == want


def test_replica_set_is_cyclic_from_the_digests_leading_bits():
    from dfs_tpu_torch.ring import static_replica_set

    ids = [1, 2, 3, 4, 5]
    for i in range(64):
        dg = anchored.file_id(bytes([i]))
        assert anchored.replica_set(dg, ids, 2) \
            == static_replica_set(dg, ids, 2)
    assert anchored.replica_set("f" * 64, ids, 2) == [
        ids[int("f" * 16, 16) % 5], ids[(int("f" * 16, 16) + 1) % 5]]


def test_params_are_frozen_and_refuse_bad_sizes():
    p = anchored.params_for(2048, 8192, 65536)
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.seg_max = 1
    with pytest.raises(ValueError):
        anchored.params_for(2048, 6000, 65536)
