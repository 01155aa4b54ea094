"""Device operations per epoch, from the trace of one training run."""

from lib.spec import load_module

units = load_module("metrics", "_units")


def read(ctx):
    epochs = units.traced_units(ctx)
    if ctx.kind != "train_runs" or not epochs:
        return None
    return ctx.trace.device_ops / epochs
