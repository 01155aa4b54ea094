"""Median latency of every request in the window (host clock)."""

from lib.stats import percentile


def read(ctx):
    if ctx.kind != "closed_loop":
        return None
    return percentile(ctx.window["latencies"], 50) * 1e3
