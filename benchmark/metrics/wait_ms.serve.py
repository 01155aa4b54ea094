"""The host waiting for a request's forward on the card (the port's
``serve.wait`` range), ms, the median over the traced requests."""

from lib import spans


def read(ctx):
    s = spans.median_per_root("serve.predict", "serve.wait")
    return None if s is None else 1e3 * s
