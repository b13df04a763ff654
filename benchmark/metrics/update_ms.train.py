"""The program's ``train.update`` span (SGD with clipping, weight decay and
momentum, then the EMA; host clock), ms a step over the window's steps: the
last ones the process-wide timer kept (the check runs the reference alone,
no program step)."""


def read(run):
    try:
        from vbt_tpu_torch.utils.profiling import process_timer
    except ImportError:  # a program without the process-wide spans
        return None
    steps = run.cell.counters.get("steps", 0)
    calls = process_timer().last("train.update", steps)
    return 1e3 * sum(calls) / steps if steps and len(calls) == steps else None
