"""Analytic forward FLOPs of every frame the window's videos ran through
the forward (a short last batch padded), over the window, against 989
TFLOP/s bf16."""
from benchmark.core.readings import forwarded_frames, mfu_pct


def read(run):
    c = run.cell
    frames = sum(forwarded_frames(c.plans[k].frames, c.mix["batch"]) for k, *_ in c.done)
    return mfu_pct(run, frames)
