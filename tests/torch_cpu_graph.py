"""A stand-in of ``runtime/graphs.py::Graph`` that runs on the CPU, for the
graph path's CPU tests (detect and train).

- Its capture runs ``fn`` once on the static inputs and puts the
  generators back, as a CUDA capture leaves them where they were;
  ``Graph.capture``'s own accounting puts the launch counters back.
- Each replay runs ``fn`` again on the static inputs (its spans into a
  timer of its own, its launches taken back: a replay runs no Python) and
  writes its tensors into the captured outputs; ``Graph.replay`` then adds
  the launches the capture counted.
- Its pool is the bytes of the outputs it captured (a CUDA graph's private
  pool holds them, and the chain's intermediates besides).
- ``CpuGraph.made`` counts the graphs made, ``closed`` marks a closed one.

:func:`use_cpu_graphs` puts it in place of ``Graph``, and an eager
``run_on`` (the CPU has no streams) that notes the stream it was given.
"""

import torch
from torch.utils._pytree import tree_leaves

from vbt_tpu_torch.runtime import graphs
from vbt_tpu_torch.utils.profiling import StageTimer, add_launches, launch_counts


class CpuGraph(graphs.Graph):
    made = 0

    def __init__(self, *args):
        super().__init__(*args)
        self.closed = False
        CpuGraph.made += 1

    def _record(self, fn):
        states = [g.get_state() for g in self.generators]
        self.fn = fn
        out = fn(self.inputs, self.scalars)
        for g, state in zip(self.generators, states):
            g.set_state(state)
        return out

    def _pool_bytes(self):
        return sum(t.nbytes for t in self.outputs)

    def _launch(self):
        before = launch_counts()
        with StageTimer().stage("replay"):
            leaves = tree_leaves(self.fn(self.inputs, self.scalars))
        add_launches({k: n - before.get(k, 0) for k, n in launch_counts().items()}, -1)
        new = [t for t, a in zip(leaves, self.aliases) if isinstance(t, torch.Tensor) and a is None]
        for out, t in zip(self.outputs, new):
            out.copy_(t)

    def close(self):
        super().close()
        self.closed = True


def use_cpu_graphs(monkeypatch, graph=CpuGraph) -> list:
    """``graph`` in place of ``Graph`` and an eager ``run_on``; returns the
    list of the streams the eager calls were given."""
    ran_on = []

    def run_on(stream, fn):
        ran_on.append(stream)
        return fn()

    monkeypatch.setattr(graphs, "Graph", graph)
    monkeypatch.setattr(graphs, "run_on", run_on)
    return ran_on
