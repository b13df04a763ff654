"""The program's ``analysis`` and ``phases`` spans (K4, which samples
ended a phase, the phase list), ms a chunk."""
from benchmark.core.readings import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "analysis", "phases", per="chunks")
