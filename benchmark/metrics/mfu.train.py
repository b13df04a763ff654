"""Three times the analytic forward FLOPs (forward and backward, the
convention of ``counts/flops.py``) of every image the window's steps
trained on, over the window, against 989 TFLOP/s (the step computes in
float32 with TF32 off, so the share is of the tensor cores' bf16 peak, the
chip's, not of what float32 can reach)."""
from benchmark.core.readings import train_mfu_pct


def read(run):
    return train_mfu_pct(run, run.cell.counters.get("images", 0))
