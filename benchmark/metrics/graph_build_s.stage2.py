"""The host build of a stage-2 run's graph (the port's ``stage2.graph``
range: the train mask, ``to_undirected``, the graph, its self loops and
its copy to the card), seconds a traced run."""

from lib import spans


def read(ctx):
    return spans.mean_per_root("stage2.train", "stage2.graph")
