"""Three times the analytic forward FLOPs of EfficientDet-D7x
(``counts/flops_d7x.py``: squeeze-excite's convolutions counted, swish and
the sum fusion not, six pyramid levels) of every image the window's steps
trained on, over the window, against 989 TFLOP/s (the tensor cores' bf16
peak, the chip's; the step computes in float32 with TF32 off), as
``mfu_effdet.train`` is for D3."""
from benchmark.core import card
from benchmark.counts.flops import TRAIN_FACTOR
from benchmark.counts.flops_d7x import D_SPECS, forward_flops


def read(run):
    images = run.cell.counters.get("images", 0)
    spec = run.config.get("spec")
    if not images or run.window_s <= 0 or spec not in D_SPECS:
        return None
    flops = TRAIN_FACTOR * images * forward_flops(spec)
    return 100.0 * flops / run.window_s / card.BF16_FLOPS
