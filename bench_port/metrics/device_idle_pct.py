"""The share of the traced window in which no operation ran on the
device (%)."""


def read(run):
    t = run["trace"]
    if not t or not t["busy_s"] or not run["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / run["window_s"])
