"""A training epoch's steady time as the trainer's ``EpochTimer``
reports it (``mean_epoch_time``), the mean over the window's runs."""


def read(ctx):
    recs = [r for r in ctx.window.get("records", [])
            if r.get("mean_epoch_time")]
    if not recs:
        return None
    return 1e3 * sum(r["mean_epoch_time"] for r in recs) / len(recs)
