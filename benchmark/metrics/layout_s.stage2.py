"""The layouts of a stage-2 run's graph (the port's ``stage2.layout``
range: ``adjacency_from_graph``), seconds a traced run."""

from lib import spans


def read(ctx):
    return spans.mean_per_root("stage2.train", "stage2.layout")
