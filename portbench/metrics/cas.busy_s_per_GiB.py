"""Seconds the CAS tier's I/O workers spent doing I/O (``/metrics``
``ingest.cas.busyS``), summed over the nodes across the window, per GiB
acknowledged. Layer: CAS tier (``store/cas.py``, ``store/aio.py``)."""

SOURCE, UNIT, MOVES = "program_counter", "s/GiB", "upload_GiBps"


def read(ctx):
    return ctx.per_gib(ctx.delta(lambda m: m["ingest"]["cas"]["busyS"]))
