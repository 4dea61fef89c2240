"""The least time the chunk-and-hash work of the replayed bodies needs at
the H100's peaks (``workcount.work``: the input's bytes and operations,
counted from the input and its reference chunk table), as a share of the
device time of every device op of the profiled fragment calls (the union
of their intervals in the trace). Layer: kernels (``csrc/*.cu`` and the
plain-torch stages)."""

from portbench import workcount

SOURCE, UNIT, MOVES = "device_trace", "%", "upload_GiBps"


def read(ctx):
    r = ctx.replay
    if r is None or not r["busy_s"] > 0 or not ctx.profiled_lengths:
        return None
    w = workcount.work(r["profiled_bytes"],
                       [ln for lengths in ctx.profiled_lengths
                        for ln in lengths])
    return 100.0 * w["bound_s"] / r["busy_s"]
