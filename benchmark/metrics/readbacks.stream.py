"""The calls of every ``<stage>.readback`` span of the program (one a tensor
read from the card), a chunk."""


def read(run):
    names = [n for n in run.cell.spans if n.endswith(".readback")]
    chunks = run.cell.counters.get("chunks")
    if not names or not chunks:
        return None
    return sum(run.cell.spans[n][1] for n in names) / chunks
