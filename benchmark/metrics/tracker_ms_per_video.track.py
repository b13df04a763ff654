"""The program's ``tracker[scan]`` span (K3 and the readback of its
outputs), ms a video."""
from benchmark.core.readings import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "tracker[scan]")
