"""Stage 1's capture of an epoch in a CUDA graph (the port's
``stage1.capture`` range: the synchronize before it and the capture), ms
a traced run."""

from lib import spans


def read(ctx):
    s = spans.mean_per_root("stage1.train", "stage1.capture")
    return None if s is None else 1e3 * s
