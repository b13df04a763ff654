"""The program's ``train.augment`` span (``DeviceDataTrainer.augment``: the
gather, ``draw_mosaic`` and ``augment_mosaic_and_normalize``; host clock),
ms a step over the window's steps: the last ones the process-wide timer kept
(the check runs the reference alone, no program step)."""


def read(run):
    try:
        from vbt_tpu_torch.utils.profiling import process_timer
    except ImportError:  # a program without the process-wide spans
        return None
    steps = run.cell.counters.get("steps", 0)
    calls = process_timer().last("train.augment", steps)
    return 1e3 * sum(calls) / steps if steps and len(calls) == steps else None
