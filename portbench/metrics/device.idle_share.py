"""The share of the window in which no kernel ran on the card, from
``nvidia-smi``'s ``utilization.gpu`` sampled 10 times a second across the
window: 100 less the mean. It covers the whole card, all five node
processes. Layer: device (H100)."""

SOURCE, UNIT, MOVES = "device_trace", "%", "upload_GiBps"


def read(ctx):
    if not ctx.smi:
        return None
    return 100.0 - sum(r[1] for r in ctx.smi) / len(ctx.smi)
