"""Milliseconds a 64 MiB region of the cell's own upload bodies takes
through the node's fragmenter in the harness's process, between device
synchronisations (the replay). Layer: walk and chain
(``fragmenter/cdc_anchored.py``, ``ops/cdc_anchored.py``)."""

SOURCE, UNIT, MOVES = "host_clock", "ms", "upload_GiBps"


def read(ctx):
    if ctx.replay is None:
        return None
    return ctx.replay["ms_per_region"]
