"""The program's ``detect.forward`` span (preprocess and the eager bf16
forward's launches, host clock), ms a chunk."""
from benchmark.core.readings import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "detect.forward", per="chunks")
