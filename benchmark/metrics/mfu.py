"""The whole step's share of the chip's peak (``.train``: epochs;
``.serve``: predicts): the model operations of the traced window over
its length and the peak of the precision the configuration's matmuls run
in, in percent."""

from lib.spec import load_module

units = load_module("metrics", "_units")


def read(ctx):
    n = units.traced_units(ctx)
    if not n:
        return None
    flops = ctx.costs.model_flops(ctx.costs.sizes(ctx), units.mode(ctx)) * n
    peak = ctx.peaks[ctx.config["precision"]["matmul"]]
    return 100.0 * flops / ctx.trace.window_s / peak
