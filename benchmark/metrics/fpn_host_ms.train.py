"""The program's ``model.fpn`` span (the BiFPN's launches inside
``train.forward``; host clock), ms a step over the window's steps: the last
ones the process-wide timer kept. A program without the span reads
nothing."""


def read(run):
    try:
        from vbt_tpu_torch.utils.profiling import process_timer
    except ImportError:  # a program without the process-wide spans
        return None
    steps = run.cell.counters.get("steps", 0)
    calls = process_timer().last("model.fpn", steps)
    return 1e3 * sum(calls) / steps if steps and len(calls) == steps else None
