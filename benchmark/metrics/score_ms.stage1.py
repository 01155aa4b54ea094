"""The host's work at stage 1's segment ends, the card idle (the port's
``stage1.score`` ranges: history, train F1, numerics, the evaluation and
the best weights' copy), summed over a traced run, ms."""

from lib import spans


def read(ctx):
    s = spans.mean_per_root("stage1.train", "stage1.score")
    return None if s is None else 1e3 * s
