"""The mean, over the window's bound pods, of the program's own bind
stamp: from the gang's submission to the end of the round that placed
the pod (``BatchStats.round_end_seconds``, plus the pre-pass and audit
before the first round), inside the schedule call (ms). Where the
collector's pauses fall before or after a round's end moves it."""


def read(run):
    n = sum(g["binds"] for g in run["gangs"])
    return 1e3 * sum(g["round_bind_sum_s"] for g in run["gangs"]) / n if n else None
