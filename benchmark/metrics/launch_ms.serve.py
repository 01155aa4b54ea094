"""A request's row update and forward launches (the port's
``serve.update`` and ``serve.forward`` ranges), ms, the median over the
traced requests."""

from lib import spans


def read(ctx):
    s = spans.median_per_root("serve.predict", "serve.update",
                              "serve.forward")
    return None if s is None else 1e3 * s
