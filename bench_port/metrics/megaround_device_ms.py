"""Device time of the megaround a gang: ``attrs.device_s`` of the
program's span ``megaround_replay``, CUDA events around each replay of
the graph and so every pass of its WHILE node, a mean over the window's
gangs (ms); nothing where no replay was recorded."""

from bench_port.recorded import span_ms


def read(run):
    return span_ms(run, "megaround_replay", attr="device_s")
