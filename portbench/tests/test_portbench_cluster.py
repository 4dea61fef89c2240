"""The data root's writes as ``write_amp`` counts them: new files whole,
grown files by their growth, and a file written anew under its old name
(another inode) whole, chunk files too."""

from __future__ import annotations

import os

from portbench import cluster

DIGEST = "ab" * 32


def _cluster(tmp_path):
    c = cluster.Cluster.__new__(cluster.Cluster)
    c.data = tmp_path
    return c


def test_new_and_grown_files_count_their_new_bytes(tmp_path):
    c = _cluster(tmp_path)
    (tmp_path / "log").write_bytes(b"x" * 10)
    before = c.files()
    with open(tmp_path / "log", "ab") as f:
        f.write(b"y" * 5)
    (tmp_path / "chunks").mkdir()
    (tmp_path / "chunks" / DIGEST).write_bytes(b"z" * 7)
    assert c.grown_bytes(before) == 5 + 7
    assert c.total_bytes() == 15 + 7


def test_a_chunk_file_written_anew_counts_whole(tmp_path):
    c = _cluster(tmp_path)
    (tmp_path / DIGEST).write_bytes(b"z" * 7)
    before = c.files()
    assert c.grown_bytes(before) == 0
    (tmp_path / "tmp").write_bytes(b"z" * 7)
    os.replace(tmp_path / "tmp", tmp_path / DIGEST)
    assert c.grown_bytes(before) == 7


def test_a_file_renamed_over_counts_whole(tmp_path):
    c = _cluster(tmp_path)
    (tmp_path / "manifest").write_bytes(b"m" * 9)
    before = c.files()
    (tmp_path / "tmp").write_bytes(b"n" * 9)
    os.replace(tmp_path / "tmp", tmp_path / "manifest")
    assert c.grown_bytes(before) == 9
