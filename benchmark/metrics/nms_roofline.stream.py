"""K1 (``csrc/nms.cu``): the least time a launch needs, by its bytes or
operations (``counts/kernels.py::nms_work`` over the window's own
detections), over its mean device time in the trace."""

from benchmark.core.readings import kernel
from benchmark.counts.kernels import bound_s, nms_work


def read(run):
    k = kernel(run, "nms_kernel")
    if k is None:
        return None
    seconds, launches = k
    c = run.cell
    selected = sum(int((rows[..., 4] > 0).sum()) for _, rows, *_ in c.done)
    chunks = sum(-(-c.plans[k_].frames // c.mix["chunk"]) for k_, *_ in c.done)
    if not chunks:
        return None
    bound = bound_s(*nms_work(c.mix["chunk"], selected / chunks))
    return 100.0 * bound / (seconds / launches)
