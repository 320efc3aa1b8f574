"""Rounds a gang takes (``BatchStats.rounds``), the megaround counted as
round 0, averaged over the window's gangs."""


def read(run):
    g = run["gangs"]
    return sum(x["rounds"] for x in g) / len(g) if g else None
