"""Host time a gang spends turning the native assign's buffers into the
node mirror's claims (the program's span ``materialize``), a mean over
the window's gangs (ms); nothing where the recorder recorded none."""

from bench_port.recorded import span_ms


def read(run):
    return span_ms(run, "materialize")
