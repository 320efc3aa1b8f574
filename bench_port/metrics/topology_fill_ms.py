"""Host time a gang spends building each placed pod's topology (the
program's span ``topology_fill``, inside ``final_sync``), a mean over
the window's gangs (ms); nothing where the recorder recorded none."""

from bench_port.recorded import span_ms


def read(run):
    return span_ms(run, "topology_fill")
