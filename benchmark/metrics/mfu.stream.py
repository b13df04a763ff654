"""Analytic forward FLOPs of every chunk the window ran (chunk frames
each, a padded one included), over the window, against 989 TFLOP/s bf16."""
from benchmark.core.readings import mfu_pct


def read(run):
    return mfu_pct(run, run.cell.counters.get("chunks", 0) * run.cell.mix["chunk"])
