"""Time the cyclic garbage collector paused the process inside the
window, from ``gc.callbacks``, a gang (ms)."""


def read(run):
    g = run["gangs"]
    return 1e3 * run["gc_pause_s"] / len(g) if g else None
