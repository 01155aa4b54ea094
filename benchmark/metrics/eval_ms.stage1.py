"""Stage 1's evaluations (the port's ``stage1.eval`` ranges: the device
evaluator's encodes, pairs drawn and scored, counts copied to the host),
summed over a traced run, ms."""

from lib import spans


def read(ctx):
    s = spans.mean_per_root("stage1.train", "stage1.eval")
    return None if s is None else 1e3 * s
