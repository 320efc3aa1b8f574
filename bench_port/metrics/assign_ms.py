"""Host time a gang spends in the native assign and the materialization
after it (``BatchStats.assign_seconds``), averaged over the window's
gangs (ms)."""


def read(run):
    g = run["gangs"]
    return 1e3 * sum(x["assign_s"] for x in g) / len(g) if g else None
