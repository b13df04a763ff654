"""The program's ``detect.postprocess`` span (anchor decode and K1's
launch, host clock), ms a chunk."""
from benchmark.core.readings import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "detect.postprocess", per="chunks")
