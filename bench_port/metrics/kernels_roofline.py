"""The kernels' share of their roofline (%): the least time their work
could take (``roofline.py``: each solve pass reads every node's state
once, at 3.35 TB/s) over the kernel time the trace shows."""


def read(run):
    t = run["trace"]
    if not t or not t["kernel_s"] or not run["least_s"]:
        return None
    return 100.0 * run["least_s"] / t["kernel_s"]
