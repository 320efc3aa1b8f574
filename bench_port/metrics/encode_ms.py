"""Host time a gang spends encoding its pods (``BatchStats.phases
["encode"]``), averaged over the window's gangs (ms)."""


def read(run):
    g = run["gangs"]
    return 1e3 * sum(x["encode_s"] for x in g) / len(g) if g else None
