"""Peer RPCs the nodes made, every op (``/metrics`` ``rpcClient`` call
counts), summed over the nodes across the window, per GiB acknowledged.
Layer: rpc (``comm/rpc.py``)."""

SOURCE, UNIT, MOVES = "program_counter", "calls/GiB", "upload_GiBps"


def read(ctx):
    return ctx.per_gib(ctx.delta(
        lambda m: sum(r["count"] for r in m["rpcClient"].values())))
