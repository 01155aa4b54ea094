"""What a traced window holds: the epochs of the traced training run, or
the requests traced; and the mode the cost functions count them in."""


def traced_units(ctx):
    if ctx.trace is None:
        return 0
    if ctx.kind == "train_runs":
        return sum(r["epochs"] for r in ctx.window["records"] if r["traced"])
    return ctx.window["traced"]


def mode(ctx) -> str:
    return "train" if ctx.kind == "train_runs" else "serve"
