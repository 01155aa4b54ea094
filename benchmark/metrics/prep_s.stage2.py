"""Host set-up inside a stage-2 run: the harness's clock around
``train_ktgnn`` less the run's own ``total_time`` (graph preparation,
layouts, the model's build), the mean over the window's runs."""


def read(ctx):
    recs = [r for r in ctx.window.get("records", []) if "total_time" in r]
    if not recs:
        return None
    return sum(r["wall_s"] - r["total_time"] for r in recs) / len(recs)
