"""Host time a gang spends selecting winners (``BatchStats.select_seconds``),
averaged over the window's gangs (ms)."""


def read(run):
    g = run["gangs"]
    return 1e3 * sum(x["select_s"] for x in g) / len(g) if g else None
