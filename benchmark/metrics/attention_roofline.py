"""The attention layer's share of its roofline, per training epoch
(``.train``) or per predict (``.serve``): the least time of its work
(the configuration's cost functions) over the device time of its
hand-written kernels in the trace, in percent. Nothing when the trace
holds none of them."""

from lib.spec import load_module

units = load_module("metrics", "_units")


def read(ctx):
    n = units.traced_units(ctx)
    if not n:
        return None
    spent, count = ctx.trace.time_of(ctx.costs.ATTENTION_KERNELS)
    if not count:
        return None
    least = ctx.costs.attention_least_s(ctx.costs.sizes(ctx),
                                        units.mode(ctx), ctx.peaks)
    return 100.0 * least * n / spent
