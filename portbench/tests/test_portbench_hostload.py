"""The window's CPU seconds by process group: the harness's own work
shows, a process that is gone reads 0."""

from __future__ import annotations

import os

from portbench import hostload


def test_cpu_seconds_of_a_group_over_a_window():
    groups = {"me": [os.getpid()], "gone": [2**22 + 1]}
    before = hostload.snapshot(groups)
    x = 0
    for i in range(3_000_000):
        x += i
    after = hostload.snapshot(groups)
    out = hostload.window(before, after, 2.0)
    assert out["me"]["cpu_s"] > 0
    assert abs(out["me"]["cores"] - out["me"]["cpu_s"] / 2.0) < 1e-3
    assert out["gone"] == {"cpu_s": 0.0, "cores": 0.0}
