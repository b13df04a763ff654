"""CUDA graphs of the detection pipeline's device chain, and when to take one.

The eager chain behind :meth:`~vbt_tpu_torch.runtime.pipeline.DetectionPipeline.detect_batch`
(preprocess, the EfficientDet forward, the candidate prefilter, the decode
and the NMS kernel's launch) is about a thousand small launches a 64-frame
batch, and the host issuing them, not the card running them, sets its time.
A captured graph issues them all in one launch.

- :class:`CapturePolicy` decides, for each key (everything a graph bakes
  in: the batch shape, the score threshold, the prefilter, the
  postprocess), whether a call runs eagerly, captures or replays. It needs
  no card.
- :class:`ChainGraph` is one captured graph: a static input the caller's
  batch is copied into, the static outputs a replay writes, and the kernel
  launches the graph holds, which each replay adds to the kernels' launch
  counters (``nms.launches``, ``fused_mbconv.launches`` and
  ``fused_mbconv.launches_by_variant``, and the int8 lane's
  ``int8_matmul.calls``) as the eager chain's launches do.
- :class:`StepGraph` is one captured graph of a step whose inputs are many
  tensors and a few scalars: the device-resident train step's
  (:mod:`vbt_tpu_torch.train.fused`).
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from collections.abc import Callable, Hashable

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from vbt_tpu_torch.models.quant import int8_matmul
from vbt_tpu_torch.ops.fused_mbconv import fused_mbconv
from vbt_tpu_torch.ops.nms_cuda import nms

EAGER, CAPTURE, REPLAY = "eager", "capture", "replay"


class CapturePolicy:
    """Per key: the first call runs eagerly (cuDNN's, the allocator's and
    the kernels' first-launch set-up), the second captures a graph, every
    later call replays it.

    At most ``capacity`` keys are kept, graphs and keys seen once alike;
    the key used longest ago goes first, and its graph is closed (its
    private memory pool freed). A key whose capture raised is served
    eagerly from then on and never captured again; ``failures`` counts
    them."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.graphs: OrderedDict[Hashable, object | None] = OrderedDict()  # None: seen once
        self.refused: set = set()
        self.failures = 0

    def use(self, key: Hashable) -> str:
        """What this call of ``key`` does: :data:`EAGER`, :data:`CAPTURE`
        (then :meth:`keep` or :meth:`refuse`) or :data:`REPLAY`."""
        if key in self.refused:
            return EAGER
        if key not in self.graphs:
            while len(self.graphs) >= self.capacity:
                graph = self.graphs.popitem(last=False)[1]
                if graph is not None:
                    graph.close()
            self.graphs[key] = None
            return EAGER
        self.graphs.move_to_end(key)
        return CAPTURE if self.graphs[key] is None else REPLAY

    def keep(self, key: Hashable, graph) -> None:
        """``key``'s graph, captured on the call :meth:`use` said to."""
        self.graphs[key] = graph

    def refuse(self, key: Hashable, err: Exception) -> None:
        """``key``'s capture raised ``err``: serve it eagerly from now on."""
        self.graphs.pop(key, None)
        self.refused.add(key)
        self.failures += 1
        warnings.warn(f"CUDA graph capture failed for {key!r}; served eagerly from now on: {err}",
                      RuntimeWarning, stacklevel=3)

    def __getitem__(self, key: Hashable):
        return self.graphs[key]


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


def _launch_counts() -> dict[str, int]:
    return {"nms": nms.launches, "fused_mbconv": fused_mbconv.launches,
            "int8_matmul": int8_matmul.calls,
            **{f"fused_mbconv.{v}": n for v, n in fused_mbconv.launches_by_variant.items()}}


def _add_launches(counts: dict[str, int], sign: int = 1) -> None:
    nms.launches += sign * counts["nms"]
    fused_mbconv.launches += sign * counts["fused_mbconv"]
    int8_matmul.calls += sign * counts["int8_matmul"]
    for v in fused_mbconv.launches_by_variant:
        fused_mbconv.launches_by_variant[v] += sign * counts[f"fused_mbconv.{v}"]


class ChainGraph:
    """One CUDA graph of a chain of ``x``'s shape, dtype and device.

    ``ChainGraph(x)`` copies ``x`` into the static input; :meth:`warm_up`
    runs the chain eagerly on the graph's own stream (the warm-up
    ``torch.cuda.graph`` asks for, whose outputs are that call's result);
    :meth:`capture` records it into a graph with a private memory pool.
    Then each call copies its batch into the static input (:meth:`load`),
    replays (:meth:`replay`) and reads :attr:`outputs`, which the next
    replay overwrites."""

    def __init__(self, x: torch.Tensor):
        self.device = x.device
        self.input = x.clone()
        self.stream = torch.cuda.Stream(self.device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs = None
        self.launches = dict.fromkeys(_launch_counts(), 0)

    def warm_up(self, fn: Callable[[torch.Tensor], tuple]) -> tuple:
        """``fn(input)`` run eagerly on the graph's stream (:func:`run_on`),
        its launches counted as any eager launch."""
        return run_on(self.stream, lambda: fn(self.input))

    def capture(self, fn: Callable[[torch.Tensor], tuple]) -> None:
        """Record ``fn(input)`` into the graph. Nothing runs, so the launch
        counters are put back and the launches kept for :meth:`replay`."""
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(graph, stream=self.stream):
                outputs = fn(self.input)
        finally:
            self.launches = {k: n - before[k] for k, n in _launch_counts().items()}
            _add_launches(self.launches, -1)
        self.graph, self.outputs = graph, outputs

    def load(self, x: torch.Tensor) -> None:
        """Copy ``x`` into the static input, on the current stream: in
        stream order after every replay already queued, which still read
        the input before."""
        self.input.copy_(x)

    def replay(self) -> None:
        """Launch the graph on the current stream and count the kernel
        launches it holds."""
        self.graph.replay()
        _add_launches(self.launches)

    def close(self) -> None:
        """Free the graph and its private pool (the outputs are its memory)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.outputs = self.input = None


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


class StepGraph:
    """One CUDA graph of a step whose inputs are many tensors and a few
    scalars, captured on ``stream``.

    ``StepGraph(inputs, scalars, dtype, generators, stream)`` copies the
    tensors ``inputs`` into static ones and holds the numbers ``scalars``
    as 0-dim tensors of ``dtype``, which the graph reads where an eager
    step takes Python numbers; ``generators`` are registered with the
    graph, so that a replay draws from their state and advances it as the
    eager step does. :meth:`capture` records ``fn(inputs, scalars)``,
    whose result may nest tuples, lists, dicts and named tuples; the step
    must have run eagerly on ``stream`` before (:func:`run_on`), the
    warm-up ``torch.cuda.graph`` asks for. Then each call copies its inputs
    and scalars in (:meth:`load`), replays (:meth:`replay`) and takes the
    result (:meth:`fresh_outputs`): its tensors copied out of the graph's
    pool, which the next replay overwrites, and an output that is one of
    the static inputs handed back as the caller's own input in its
    place."""

    def __init__(self, inputs: list, scalars: list, dtype: torch.dtype, generators,
                 stream: torch.cuda.Stream):
        self.device = inputs[0].device
        self.inputs = [x.clone() for x in inputs]
        self.input_groups = _dtype_groups(self.inputs)
        self.scalars = [torch.tensor(v, dtype=dtype, device=self.device) for v in scalars]
        self.generators = tuple(generators)
        self.stream = stream
        self.graph: torch.cuda.CUDAGraph | None = None
        self.leaves = self.spec = self.aliases = self.outputs = self.output_groups = None

    def capture(self, fn: Callable[[list, list], object]) -> None:
        """Record ``fn(inputs, scalars)`` on the static tensors into the
        graph. Nothing runs, and the generators do not advance;
        ``torch.cuda.graph`` frees the cached blocks first, so that the
        graph's private pool takes the eager steps' room."""
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        with torch.cuda.device(self.device), torch.cuda.graph(graph, stream=self.stream):
            out = fn(self.inputs, self.scalars)
        self.graph = graph
        self.keep(out)

    def keep(self, out) -> None:
        """Note the captured result ``out``: its leaves, their nesting, and
        which of its tensors are static inputs."""
        self.leaves, self.spec = tree_flatten(out)
        static = {id(x): i for i, x in enumerate(self.inputs)}
        self.aliases = [static.get(id(t)) if isinstance(t, torch.Tensor) else None
                        for t in self.leaves]
        self.outputs = [t for t, a in zip(self.leaves, self.aliases)
                        if isinstance(t, torch.Tensor) and a is None]
        self.output_groups = _dtype_groups(self.outputs)

    def load(self, inputs: list, scalars: list) -> None:
        """Copy ``inputs`` into the static tensors and fill the scalars, on
        the current stream: in stream order after every replay already
        queued, which still read them before."""
        _copy_into(self.inputs, inputs, self.input_groups)
        for t, v in zip(self.scalars, scalars):
            t.fill_(v)

    def replay(self) -> None:
        """Launch the graph on the current stream."""
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
