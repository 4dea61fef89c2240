"""Seconds the fragmenter's walk blocked on placement's byte credit
(``/metrics`` ``ingest.stalls.creditS``), summed over the nodes across the
window, per GiB acknowledged. Layer: runtime (``node/runtime.py``)."""

SOURCE, UNIT, MOVES = "program_counter", "s/GiB", "upload_GiBps"


def read(ctx):
    return ctx.per_gib(ctx.delta(
        lambda m: m["ingest"]["stalls"].get("creditS", 0.0)))
