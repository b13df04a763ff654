"""The program's ``track`` span (K3 with the state carried, and the
readback of its outputs), ms a chunk."""
from benchmark.core.readings import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "track")
