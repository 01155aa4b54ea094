"""The host scoring between scan mode's chunks, the card idle (the
port's ``stage2.score`` ranges: scores, records, checkpoint), summed over
a traced run, ms."""

from lib import spans


def read(ctx):
    s = spans.mean_per_root("stage2.train", "stage2.score")
    return None if s is None else 1e3 * s
