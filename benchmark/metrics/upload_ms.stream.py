"""The program's ``detect.upload`` span (``DetectionPipeline._frames``: the
lent staging buffer handed to the copy stream and the compute stream's wait
enqueued), ms a chunk."""
from benchmark.core.readings import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "detect.upload", per="chunks")
