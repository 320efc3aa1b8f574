"""Host time a gang spends in the native assign's call (the program's
span ``native_assign``), a mean over the window's gangs (ms); nothing
where the recorder recorded none."""

from bench_port.recorded import span_ms


def read(run):
    return span_ms(run, "native_assign")
