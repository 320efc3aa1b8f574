"""Megaround graphs captured inside the window: the change in
``speculate.graph_stats()["captures"]`` across it. Warm-up should leave
it at 0."""


def read(run):
    return float(run["captures"])
