"""CUDA graphs of the port's device chains: one mechanism for every graphed entry.

The detect chain behind
:meth:`~vbt_tpu_torch.runtime.pipeline.DetectionPipeline.detect_batch` and
the train step behind :meth:`~vbt_tpu_torch.train.fused.DeviceDataTrainer.step`
are each hundreds to thousands of small launches, and the host issuing
them, not the card running them, sets their time; a graph issues them all
in one launch.

:class:`GraphedCalls` holds one owner's graphs and serves its calls. The
owner hands it a key (everything a graph bakes in), the call's input
tensors and scalars, and ``fn(inputs, scalars)``, the chain to run or
capture, and gets back the chain's result. Per key: the first call runs
``fn`` eagerly on the owner's stream (:func:`run_on`: the warm-up
``torch.cuda.graph`` asks for), the second captures it on that stream and
is served by the graph's first replay, every later call replays. At most
``capacity`` keys are kept, graphs and keys seen once alike; the key used
longest ago goes first and its graph is closed (its private memory pool
freed). A key whose capture raised is served eagerly from then on, with a
warning; ``failures`` counts them. The capture's spans go into a timer of
their own (they time no call); a replay records the owner's
:class:`ReplaySpans`.

A :class:`Graph` hands back its result with the tensors copied out of its
pool, which the next replay overwrites, so that a caller may hold the
results of several calls. Its capture measures that pool, the bytes of the
allocator's segments under the graph's pool id (``pool_bytes``): the
memory a graphed chain holds on the card between replays, a train step's
activations. :func:`pool_bytes` keeps, for each owner's ``name``
(``"detect"``, ``"train"``), the largest pool captured under it in the
process; closing a graph leaves the reading. Every launch counter a kernel
binding registered (:func:`~vbt_tpu_torch.utils.profiling.launch_counter`)
grows on each replay by the launches the graph holds, as the eager chain's
launches grow it; the capture, which runs nothing, leaves them as they
were.
"""

from __future__ import annotations

import contextlib
import warnings
from collections import OrderedDict
from collections.abc import Callable, Hashable
from typing import NamedTuple

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from vbt_tpu_torch.utils.profiling import StageTimer, add_launches, launch_counts, span

# GraphedCalls name -> the largest private pool, in bytes, of a graph
# captured under it in this process.
_POOL_BYTES: dict[str, int] = {}


def pool_bytes() -> dict[str, int]:
    """The largest captured graph's private pool a :class:`GraphedCalls`
    name, in bytes (process-wide; names with no capture are absent)."""
    return dict(_POOL_BYTES)


def run_on(stream: torch.cuda.Stream, fn: Callable[[], object]):
    """``fn()`` run eagerly on ``stream``, after the work the current
    stream has queued; its result, tensors in any nesting of tuples, lists
    and dicts, is safe to use on the current stream."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    for t in tree_leaves(out):
        if isinstance(t, torch.Tensor):
            t.record_stream(current)
    return out


def _dtype_groups(tensors: list) -> list[list[int]]:
    """The positions of ``tensors``, a list for each dtype: a ``_foreach_``
    call on a list of mixed dtypes leaves the fused kernels for a launch a
    tensor."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


def _copy_into(dst: list, src: list, groups: list[list[int]]) -> None:
    """``dst[i].copy_(src[i])`` for every ``i``, one ``_foreach_copy_`` a
    group of :func:`_dtype_groups`."""
    for g in groups:
        torch._foreach_copy_([dst[i] for i in g], [src[i] for i in g])


class Graph:
    """One CUDA graph of ``fn(inputs, scalars)``, captured on ``stream``.

    ``Graph(inputs, scalars, generators, stream)`` copies the tensors
    ``inputs`` into static ones, holds the numbers ``scalars`` as 0-dim
    float32 tensors and registers ``generators`` with the graph.
    :meth:`capture` records ``fn`` on the static tensors; its result may
    nest tuples, lists, dicts and named tuples. Then each call copies its
    inputs and scalars in (:meth:`load`), replays (:meth:`replay`) and
    takes the result (:meth:`fresh_outputs`)."""

    def __init__(self, inputs: list, scalars, generators, stream: torch.cuda.Stream | None):
        self.device = inputs[0].device
        self.inputs = [x.clone() for x in inputs]
        self.input_groups = _dtype_groups(self.inputs)
        self.scalars = [torch.tensor(v, dtype=torch.float32, device=self.device)
                        for v in scalars]
        self.generators = tuple(generators)
        self.stream = stream
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict[str, int] = {}
        self.pool_bytes = 0
        self.leaves = self.spec = self.aliases = self.outputs = self.output_groups = None

    def capture(self, fn: Callable[[list, list], object]) -> None:
        """Record ``fn(inputs, scalars)`` on the static tensors. Nothing
        runs: the launch counters are put back, and the launches kept for
        :meth:`replay`; ``pool_bytes`` is the private pool it left."""
        before = launch_counts()
        try:
            out = self._record(fn)
        finally:
            self.launches = {k: n - before.get(k, 0) for k, n in launch_counts().items()}
            add_launches(self.launches, -1)
        self.leaves, self.spec = tree_flatten(out)
        static = {id(x): i for i, x in enumerate(self.inputs)}
        self.aliases = [static.get(id(t)) if isinstance(t, torch.Tensor) else None
                        for t in self.leaves]
        self.outputs = [t for t, a in zip(self.leaves, self.aliases)
                        if isinstance(t, torch.Tensor) and a is None]
        self.output_groups = _dtype_groups(self.outputs)
        self.pool_bytes = self._pool_bytes()

    def _record(self, fn: Callable[[list, list], object]):
        """The CUDA capture: the generators do not advance, and
        ``torch.cuda.graph`` frees the cached blocks first, so that the
        graph's private pool takes the eager calls' room."""
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        with torch.cuda.device(self.device), torch.cuda.graph(graph, stream=self.stream):
            out = fn(self.inputs, self.scalars)
        self.graph = graph
        return out

    def _pool_bytes(self) -> int:
        """The bytes of the allocator's segments in the graph's private
        pool (``torch.cuda.memory_snapshot``'s ``segment_pool_id``)."""
        pool = tuple(self.graph.pool())
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def load(self, inputs: list, scalars) -> None:
        """Copy ``inputs`` into the static tensors and fill the scalars, on
        the current stream: in stream order after every replay already
        queued, which still read them before."""
        _copy_into(self.inputs, inputs, self.input_groups)
        for t, v in zip(self.scalars, scalars):
            t.fill_(v)

    def replay(self) -> None:
        """Launch the graph on the current stream and count the kernel
        launches it holds."""
        self._launch()
        add_launches(self.launches)

    def _launch(self) -> None:
        self.graph.replay()

    def fresh_outputs(self, inputs: list):
        """The last replay's result, its tensors copies of their own (an
        output that is a static input: ``inputs``' tensor in its place;
        other leaves as captured)."""
        copies = [torch.empty_like(t) for t in self.outputs]
        _copy_into(copies, self.outputs, self.output_groups)
        copies = iter(copies)
        leaves = [inputs[a] if a is not None else next(copies) if isinstance(t, torch.Tensor)
                  else t for t, a in zip(self.leaves, self.aliases)]
        return tree_unflatten(leaves, self.spec)

    def close(self) -> None:
        """Free the graph and its private pool (the outputs are its memory)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.leaves = self.outputs = self.inputs = self.scalars = None


class ReplaySpans(NamedTuple):
    """The spans a replayed call records (None: none): ``call`` around all
    of it, ``load`` around the copy in and the launch, ``launch`` around
    the launch alone, ``out`` around the copy out."""

    call: str | None = None
    load: str | None = None
    launch: str | None = None
    out: str | None = None


def _span(name: str | None):
    return contextlib.nullcontext() if name is None else span(name)


class GraphedCalls:
    """One owner's graphs, at most ``capacity`` keys, captured on
    ``stream``, and the protocol that serves its calls (module docstring);
    ``name`` files their pools' sizes under :func:`pool_bytes`."""

    def __init__(self, capacity: int, stream: torch.cuda.Stream, spans: ReplaySpans,
                 name: str | None = None):
        self.name = name
        self.capacity = capacity
        self.stream = stream
        self.spans = spans
        self.graphs: OrderedDict[Hashable, Graph | None] = OrderedDict()  # None: seen once
        self.refused: set = set()
        self.failures = 0

    def __call__(self, key: Hashable, fn: Callable[[list, list], object], inputs: list,
                 scalars=(), generators=()):
        """``fn(inputs, scalars)``: run eagerly on the owner's stream,
        captured and replayed, or replayed, as ``key``'s calls so far say."""
        if key in self.refused:
            return self._eager(fn, inputs, scalars)
        if key not in self.graphs:
            while len(self.graphs) >= self.capacity:
                graph = self.graphs.popitem(last=False)[1]
                if graph is not None:
                    graph.close()
            self.graphs[key] = None
            return self._eager(fn, inputs, scalars)
        self.graphs.move_to_end(key)
        graph = self.graphs[key]
        if graph is None:
            graph = self._capture(key, fn, inputs, scalars, generators)
            if graph is None:
                return self._eager(fn, inputs, scalars)
        s = self.spans
        with _span(s.call):
            with _span(s.load):
                graph.load(inputs, scalars)
                with _span(s.launch):
                    graph.replay()
            with _span(s.out):
                return graph.fresh_outputs(inputs)

    def _eager(self, fn, inputs: list, scalars):
        return run_on(self.stream, lambda: fn(inputs, scalars))

    def _capture(self, key: Hashable, fn, inputs: list, scalars, generators) -> Graph | None:
        """``key``'s graph, captured on the stream its first, eager, call ran
        on; None where the capture raised (the key is then served eagerly)."""
        graph = Graph(inputs, scalars, generators, self.stream)
        try:
            with StageTimer().stage("graph.capture"):  # the capture's spans time no call
                graph.capture(fn)
        except RuntimeError as err:
            graph.close()
            del self.graphs[key]
            self.refused.add(key)
            self.failures += 1
            warnings.warn(f"CUDA graph capture failed for {key!r}; served eagerly from now on: "
                          f"{err}", RuntimeWarning, stacklevel=3)
            return None
        self.graphs[key] = graph
        if self.name is not None:
            _POOL_BYTES[self.name] = max(_POOL_BYTES.get(self.name, 0), graph.pool_bytes)
        return graph

    def __getitem__(self, key: Hashable) -> Graph | None:
        return self.graphs[key]
