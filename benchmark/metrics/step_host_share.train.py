"""The program's ``train.step`` span (``DeviceDataTrainer.step``, host
clock) summed over the window's steps, the last ones the process-wide timer
kept, as a share of the window."""


def read(run):
    try:
        from vbt_tpu_torch.utils.profiling import process_timer
    except ImportError:  # a program without the process-wide spans
        return None
    steps = run.cell.counters.get("steps", 0)
    calls = process_timer().last("train.step", steps)
    if not steps or len(calls) != steps or run.window_s <= 0:
        return None
    return 100.0 * sum(calls) / run.window_s
