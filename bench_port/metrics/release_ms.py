"""Host time a gang's teardown spends in the node mirror's releases (the
program's ``release_from_topology`` tally: every call's seconds), a mean
over the window's gangs (ms); nothing where no call was tallied."""

from bench_port.recorded import tally_ms


def read(run):
    return tally_ms(run, "release_from_topology")
