"""Every ``<stage>.readback`` span of the program (``utils/profiling.py
to_host``: the host's wait for the card and the copy of one tensor) summed,
ms a chunk."""
from benchmark.core.readings import span_ms_per_call


def read(run):
    names = [n for n in run.cell.spans if n.endswith(".readback")]
    return span_ms_per_call(run, *names, per="chunks") if names else None
