"""Device time per epoch of every device operation that is not one of
the program's hand-written kernels (PyTorch's own kernels, cuBLAS,
copies), from the trace of one training run."""

from lib.spec import load_module

units = load_module("metrics", "_units")


def read(ctx):
    epochs = units.traced_units(ctx)
    if ctx.kind != "train_runs" or not epochs:
        return None
    total, _ = ctx.trace.time_of(".")
    hand, _ = ctx.trace.time_of(ctx.hand_kernels)
    return 1e3 * (total - hand) / epochs
