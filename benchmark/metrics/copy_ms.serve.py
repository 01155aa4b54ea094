"""The copy of a request's three heads to the host (the port's
``serve.copy`` range), ms, the median over the traced requests."""

from lib import spans


def read(ctx):
    s = spans.median_per_root("serve.predict", "serve.copy")
    return None if s is None else 1e3 * s
