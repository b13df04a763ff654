"""Video decode alone: the program's ``VideoReader`` over the cell's
videos into a ring of reused buffers (as into the pipeline's lent ones),
timed before the window in the traced run, ms a frame."""


def read(run):
    c = run.cell.counters
    if not c.get("decode_only_frames"):
        return None
    return 1e3 * c["decode_only_s"] / c["decode_only_frames"]
