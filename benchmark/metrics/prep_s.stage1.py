"""A stage-1 run's preparation (the port's ``stage1.graphs`` range, both
domains' graphs built and copied to the card, and ``stage1.build``, the
model, Adams, samplers and evaluator), seconds a traced run."""

from lib import spans


def read(ctx):
    return spans.mean_per_root("stage1.train", "stage1.graphs",
                               "stage1.build")
