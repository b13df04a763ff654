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
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from collections.abc import Callable, Hashable

import torch

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
        """``fn(input)`` run eagerly on the graph's stream, its launches
        counted as any eager launch; the outputs are safe to use on the
        current stream."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn(self.input)
        current.wait_stream(self.stream)
        for t in out:
            t.record_stream(current)
        return out

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
