"""Device time per stage-1 epoch of every device operation that is not
one of the program's hand-written kernels (stage 1 launches none: all of
it is PyTorch's own kernels, cuBLAS and copies), from the trace of one
training run, its evaluations included."""

from lib.spec import load_module


def read(ctx):
    return load_module("metrics", "torch_ops_ms.train").read(ctx)
