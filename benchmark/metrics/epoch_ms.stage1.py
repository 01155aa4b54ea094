"""A stage-1 epoch's steady time as the trainer's ``EpochTimer`` reports
it (``mean_epoch_time``), the mean over the window's runs."""

from lib.spec import load_module


def read(ctx):
    return load_module("metrics", "epoch_ms.train").read(ctx)
