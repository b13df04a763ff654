"""The program's ``detect`` span (upload, forward, K1 and the readback of
the detections), ms a chunk."""
from benchmark.core.readings import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "detect")
