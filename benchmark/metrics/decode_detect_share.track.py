"""The program's ``decode+detect`` span (``cli/track.py::track_one``:
decode overlapped with detection, up to the last readback) as a share of
the window."""


def read(run):
    span = run.cell.spans.get("decode+detect")
    if span is None or run.window_s <= 0:
        return None
    return 100.0 * span[0] / run.window_s
