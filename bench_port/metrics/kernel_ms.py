"""Device time of the port's kernels a gang, from the profiler's trace:
each hand-written kernel launched outside a graph, and the device span of
each megaround graph replay (ms)."""


def read(run):
    t = run["trace"]
    if not t or not t["kernel_s"] or not run["gangs"]:
        return None
    return 1e3 * t["kernel_s"] / len(run["gangs"])
