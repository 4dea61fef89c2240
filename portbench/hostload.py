"""The CPU seconds that the run's own processes (the nodes, the agents,
the harness, the card's sampler) spent over the window, read from
``/proc/<pid>/stat`` (all threads of a process). It tells a run paced by
its nodes' host work from one paced by the card."""

from __future__ import annotations

import os

_TICK = os.sysconf("SC_CLK_TCK")


def cpu_s(pid: int) -> float:
    """User + system CPU seconds of process ``pid``; 0 once it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            text = f.read()
    except OSError:
        return 0.0
    fields = text[text.rindex(")") + 2:].split()
    return (int(fields[11]) + int(fields[12])) / _TICK


def snapshot(groups: dict[str, list[int]]) -> dict[str, float]:
    """Each group's CPU seconds now."""
    return {k: sum(cpu_s(p) for p in pids) for k, pids in groups.items()}


def window(before: dict, after: dict, seconds: float) -> dict:
    """Each group's CPU seconds over the window, and in cores."""
    return {k: {"cpu_s": round(after[k] - before[k], 3),
                "cores": round((after[k] - before[k]) / seconds, 3)}
            for k in after}
