"""The share of the traced requests whose heads were copied into a
buffer of the predictor's host pool (the port's ``serve.copy`` range
with its count ``pooled`` at 1), %; nothing where no copy carries that
count (a port without the pool)."""

from lib import spans


def read(ctx):
    copies = [s for g in spans.roots("serve.predict") for s in g
              if s.name == "serve.copy"]
    if not any("pooled" in s.counts for s in copies):
        return None
    return 100.0 * sum(s.counts.get("pooled") == 1 for s in copies) \
        / len(copies)
