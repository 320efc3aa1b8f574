"""Host time of the megaround's dispatch (``BatchStats.phases
["spec_dispatch"]``), averaged over the window's gangs that ran one
(ms); nothing where no gang did."""


def read(run):
    d = [x["spec_dispatch_s"] for x in run["gangs"] if x["spec_dispatch_s"] is not None]
    return 1e3 * sum(d) / len(run["gangs"]) if d else None
