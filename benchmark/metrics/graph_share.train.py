"""The share of the window's train steps that ran as a replay of the step's
captured CUDA graph: calls of the program's ``train.replay`` span
(``DeviceDataTrainer.step``'s graph path) over the window's steps, %, from
the process-wide timer's last ``steps`` calls (the check runs the
reference alone, no program step)."""


def read(run):
    try:
        from vbt_tpu_torch.utils.profiling import process_timer
    except ImportError:  # a program without the process-wide spans
        return None
    steps = run.cell.counters.get("steps", 0)
    timer = process_timer()
    if not steps or "train.replay" not in timer.counts:
        return None
    return 100.0 * len(timer.last("train.replay", steps)) / steps
