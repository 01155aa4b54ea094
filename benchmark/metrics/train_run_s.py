"""Seconds per whole training run: the window, from the first run's start
to the last run's return, over the runs completed (host clock)."""


def read(ctx):
    if ctx.kind != "train_runs":
        return None
    return ctx.window["window_s"] / len(ctx.window["records"])
