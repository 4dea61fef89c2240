"""fsync calls of the content-addressed store (``/metrics``
``durability.fsyncs``), summed over the nodes across the window, per GiB
acknowledged. Layer: CAS tier (``store/cas.py``, ``store/aio.py``)."""

SOURCE, UNIT, MOVES = "program_counter", "1/GiB", "upload_GiBps"


def read(ctx):
    return ctx.per_gib(ctx.delta(lambda m: m["durability"]["fsyncs"]))
