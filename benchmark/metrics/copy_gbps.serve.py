"""The rate of the heads' copy to the host: the ``bytes`` of every
``serve.copy`` range of the traced requests over their summed seconds,
GB/s."""

from lib import spans


def read(ctx):
    copies = [s for g in spans.roots("serve.predict") for s in g
              if s.name == "serve.copy"]
    t = spans.seconds(copies, "serve.copy")
    if not t:
        return None
    return sum(s.counts.get("bytes", 0) for s in copies) / t / 1e9
