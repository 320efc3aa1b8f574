"""The 95th percentile of the window's gang walls: the host clock around
each ``schedule`` call, its teardown and the context refresh (ms). With
fewer than 20 gangs it lies between the two longest."""

import statistics


def read(run):
    walls = [g["wall_s"] * 1e3 for g in run["gangs"]]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=20, method="inclusive")[-1]
