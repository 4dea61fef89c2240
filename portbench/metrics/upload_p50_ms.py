"""The median of send-start -> 201 acknowledgement over the uploads
acknowledged in the window, as the agents see it (nearest rank): a
steadier reading of the latency than the end-to-end 90th percentile,
beside the throughput it moves. Layer: api (``api/http.py``, from the
agents' side)."""

SOURCE, UNIT, MOVES = "host_clock", "ms", "upload_GiBps"


def read(ctx):
    return ctx.latency_ms(0.50)
