"""The share of the window's detect calls whose device chain ran as a
captured CUDA graph: calls of the program's ``detect.replay`` span over
calls of its ``detect.forward`` span, %."""


def read(run):
    spans = run.cell.spans
    if "detect.replay" not in spans or not spans.get("detect.forward", (0, 0))[1]:
        return None
    return 100.0 * spans["detect.replay"][1] / spans["detect.forward"][1]
