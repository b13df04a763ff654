"""K3 (``csrc/track_scan.cu``): the least time a chunk's launch needs, by
its bytes or operations (``counts/kernels.py::track_scan_work`` over the
window's own tracker rows; a frame with a valid detection counts one
reported slot), over its mean device time in the trace."""
from benchmark.core.readings import kernel
from benchmark.counts.kernels import bound_s, track_scan_work


def read(run):
    k = kernel(run, "track_scan_kernel")
    if k is None:
        return None
    seconds, launches = k
    c = run.cell
    frames = valid = reported = chunks = 0
    for k_, rows, valid_mask, *_ in c.done:
        frames += len(rows)
        valid += int(valid_mask.sum())
        reported += int(valid_mask.any(axis=1).sum())
        chunks += -(-c.plans[k_].frames // c.mix["chunk"])
    if not chunks:
        return None
    bound = bound_s(*track_scan_work(1, frames / chunks, valid / chunks, reported / chunks))
    return 100.0 * bound / (seconds / launches)
