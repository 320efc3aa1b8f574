"""Host time a gang spends bringing the schedule context up to the
teardowns before the next gang (the program's span ``refresh_context``:
the delta refresh, the fast refresh and the row scatter), a mean over
the window's gangs (ms); nothing where the recorder recorded none."""

from bench_port.recorded import span_ms


def read(run):
    return span_ms(run, "refresh_context")
