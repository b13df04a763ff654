"""When the device-resident train step captures and replays a CUDA graph,
on the CPU (``runtime/graphs.py``, ``train/fused.py``).

- a CPU trainer and a data-parallel (mesh) trainer never capture and never
  record ``train.replay``;
- ``Trainer.train_step`` with explicit scalars (the learning rate and the
  EMA's decay and ``1 - decay``, as the graph gives them) equals the step
  that computes them on the host;
- ``DeviceDataTrainer.step``'s graph path, with a stand-in graph that runs
  the captured step again on the CPU at each replay
  (``tests/torch_cpu_graph.py``: a capture leaves the generator where it
  was, as a CUDA capture does; the capture call is served by the first
  replay; eager steps run on the trainer's stream): the key holds the batch
  size, the image size, the compute dtype, the jitter and the generator,
  and not ``mosaic_p``; a new key closes the old graph; replayed steps
  equal eager steps bit for bit (losses, parameters, statistics, trace,
  EMA, counts, learning rate, the generator's state after each step), with
  ``mosaic_p`` changed between replays and with a frozen subtree, whose
  statistics come back as the caller's own tensors; the state given to a
  step is unchanged after it and the next two; losses held keep their
  values across later replays; an eager step records the stage spans, a
  replay ``train.replay`` alone; a capture that raises leaves the key
  eager and counts the failure;
- ``benchmark/metrics/graph_share.train.py`` reads the replays' share of
  the window's steps, and nothing from a program without the span.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cpu_graph import CpuGraph, use_cpu_graphs  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401
from torch.utils._pytree import tree_leaves  # noqa: E402

from benchmark.core import registry  # noqa: E402
from vbt_tpu_torch.models import ModelSpec  # noqa: E402
from vbt_tpu_torch.runtime.graphs import GraphedCalls  # noqa: E402
from vbt_tpu_torch.train import fused  # noqa: E402
from vbt_tpu_torch.train.data import DetectionDataset  # noqa: E402
from vbt_tpu_torch.train.fused import DeviceDataTrainer  # noqa: E402
from vbt_tpu_torch.train.train_step import Trainer  # noqa: E402
from vbt_tpu_torch.utils import profiling  # noqa: E402
from vbt_tpu_torch.utils.profiling import StageTimer, process_timer  # noqa: E402

SIZE, N, B = 64, 8, 4
STREAM = "the trainer's stream"
JITTER = (0.5, 1.6)
MOSAIC = [0.5, 0.5, 0.5, 0.0, 1.0]  # one step each; the replays' p changes
STAGES = ("train.augment", "train.targets", "train.forward", "train.backward", "train.update",
          "model.backbone", "model.fpn")


def _dataset():
    rng = np.random.default_rng(0)
    images = np.zeros((N, SIZE, SIZE, 3), np.uint8)
    boxes = np.zeros((N, 4, 4), np.float32)
    valid = np.zeros((N, 4), bool)
    for i in range(N):
        y0, x0 = rng.integers(8, 30, 2)
        images[i, y0:y0 + 24, x0:x0 + 24] = 200
        boxes[i, 0] = [y0, x0, y0 + 24, x0 + 24]
        valid[i, 0] = True
    return DetectionDataset(images=images, boxes=boxes, valid=valid,
                            names=[str(i) for i in range(N)])


def _trainer(freeze=(), mesh=None):
    return Trainer(ModelSpec("tiny", "lite0", SIZE, 32, 1, 1), base_lr=0.05, total_steps=8,
                   warmup_steps=1, input_size=SIZE, device="cpu", freeze_top_keys=freeze,
                   mesh=mesh)


def _graphed(trainer):
    ddt = DeviceDataTrainer(trainer, _dataset(), None, mosaic_p=0.5, jitter=JITTER)
    assert ddt.graphs is None  # a CPU trainer
    ddt.graphs = GraphedCalls(1, STREAM, fused.REPLAY_SPANS, "train")
    return ddt


def _idx(i, b=B):
    return torch.arange(b * i, b * i + b) % N


def _tensors(state, metrics):
    return [t for t in tree_leaves((state, metrics)) if isinstance(t, torch.Tensor)]


def _steps(ddt, state, gen, mosaic=MOSAIC):
    """Each step's (given state, its clones, new state, metrics, generator
    state after, the process timer's span counts it added)."""
    out = []
    for i, p in enumerate(mosaic):
        before = dict(process_timer().counts)
        given = state
        clones = [t.clone() for t in _tensors(given, {})]
        state, metrics = ddt.step(given, _idx(i), gen, p)
        counts = {n: process_timer().counts.get(n, 0) - before.get(n, 0)
                  for n in ("train.step", "train.replay") + STAGES}
        out.append(SimpleNamespace(given=given, clones=clones, state=state, metrics=metrics,
                                   gen=gen.get_state(), counts=counts))
    return out


def _equal(a, b):
    x, y = _tensors(*a), _tensors(*b)
    return len(x) == len(y) and all(torch.equal(u, v) for u, v in zip(x, y))


@pytest.fixture(scope="module", params=[(), ("backbone",)], ids=["whole", "frozen_backbone"])
def runs(request):
    """The same steps from one state, eager and through the stand-in graph."""
    with pytest.MonkeyPatch.context() as mp:
        ran_on = use_cpu_graphs(mp)
        trainer = _trainer(freeze=request.param)
        start = trainer.init_state(seed=0)
        eager = DeviceDataTrainer(trainer, _dataset(), None, mosaic_p=0.5, jitter=JITTER)
        want = _steps(eager, start, torch.Generator().manual_seed(11))
        ddt = _graphed(trainer)
        gen = torch.Generator().manual_seed(11)
        got = _steps(ddt, start, gen)
        yield SimpleNamespace(trainer=trainer, ddt=ddt, gen=gen, want=want, got=got,
                              frozen=request.param, ran_on=ran_on)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_train_step_with_explicit_scalars_equals_the_hosts_own(dtype):
    trainer = Trainer(ModelSpec("tiny", "lite0", SIZE, 32, 1, 1), base_lr=0.05, total_steps=8,
                      warmup_steps=1, input_size=SIZE, device="cpu", dtype=dtype)
    ddt = DeviceDataTrainer(trainer, _dataset(), None, jitter=JITTER)
    state = trainer.init_state(seed=0)
    for i in range(2):  # the second step from a state past warm-up, its EMA decay moved
        batch = ddt.augment(_idx(i), torch.Generator().manual_seed(i), 0.5)
        want = trainer.train_step(state, batch)
        scalars = [torch.tensor(v, dtype=trainer.state_dtype)
                   for v in trainer.step_scalars(state)]
        got = trainer.train_step(state, batch, scalars)
        assert _equal(got, want) and got[1]["lr"] == want[1]["lr"], i
        assert _equal(trainer.train_step(state, batch, trainer.step_scalars(state)), want), i
        state = want[0]


def test_replayed_steps_equal_eager_steps_bit_for_bit(runs):
    for i, (got, want) in enumerate(zip(runs.got, runs.want)):
        assert _equal((got.state, got.metrics), (want.state, want.metrics)), i
        assert list(got.state.params) == list(want.state.params)
        assert torch.equal(got.gen, want.gen), i
        assert got.state.step == want.state.step == i + 1
        assert got.state.opt_state.count == want.state.opt_state.count == i + 1
        assert got.metrics["lr"] == want.metrics["lr"]
        assert got.state.opt_state.frozen == want.state.opt_state.frozen == runs.frozen
    assert [g.counts["train.replay"] for g in runs.got] == [0, 1, 1, 1, 1]
    assert runs.ran_on == [STREAM]  # the first, eager, step ran on the trainer's stream


def test_frozen_statistics_come_back_as_the_callers_own(runs):
    frozen = [k for k in runs.got[0].state.batch_stats if runs.trainer.is_frozen(k)]
    assert bool(frozen) == bool(runs.frozen)
    for got in runs.got:
        assert all(got.state.batch_stats[k] is got.given.batch_stats[k] for k in frozen)
        others = [k for k in got.state.params]
        assert all(got.state.params[k] is not got.given.params[k] for k in others)


def test_an_eager_step_records_the_stages_a_replay_train_replay_alone(runs):
    # Eager; the capture (its spans into a timer of its own), then the first
    # replay; three replays.
    for i, got in enumerate(runs.got):
        replayed = i >= 1
        assert got.counts["train.step"] == 1
        assert got.counts["train.replay"] == int(replayed)
        assert all(got.counts[n] == int(not replayed) for n in STAGES), (i, got.counts)


def test_the_key_holds_batch_size_image_size_dtype_jitter_and_generator(runs):
    key = (B, SIZE, torch.float32, JITTER, runs.gen)
    assert list(runs.ddt.graphs.graphs) == [key]  # mosaic_p changed, the key did not
    assert CpuGraph.made >= 1 and not runs.ddt.graphs[key].closed


def test_a_step_never_writes_into_the_state_it_was_given(runs):
    # Each state given is as it was after its own step and the next two,
    # and the losses held keep the values the eager steps computed.
    for got in runs.got:
        assert all(torch.equal(a, b) for a, b in zip(_tensors(got.given, {}), got.clones))
    for got, want in zip(runs.got, runs.want):
        assert all(torch.equal(got.metrics[k], want.metrics[k])
                   for k in ("loss", "cls_loss", "box_loss", "num_pos"))


def test_a_new_key_closes_the_old_graph(monkeypatch):
    use_cpu_graphs(monkeypatch)
    trainer = _trainer()
    ddt = _graphed(trainer)
    state = trainer.init_state(seed=0)
    gen = torch.Generator().manual_seed(3)
    for i in range(3):
        state, _ = ddt.step(state, _idx(i), gen, 0.5)
    old = ddt.graphs[(B, SIZE, torch.float32, JITTER, gen)]
    state, _ = ddt.step(state, _idx(0, 2), gen, 0.5)  # another batch size
    assert old.closed and list(ddt.graphs.graphs) == [(2, SIZE, torch.float32, JITTER, gen)]
    for i in range(2):
        state, _ = ddt.step(state, _idx(i, 2), gen, 0.5)
    two = ddt.graphs[(2, SIZE, torch.float32, JITTER, gen)]
    other = torch.Generator().manual_seed(3)
    ddt.step(state, _idx(0, 2), other, 0.5)  # another generator
    assert two.closed and list(ddt.graphs.graphs) == [(2, SIZE, torch.float32, JITTER, other)]


def test_a_failed_capture_leaves_the_key_eager(monkeypatch):
    class Failing(CpuGraph):
        def _record(self, fn):
            raise RuntimeError("operation not permitted when stream is capturing")

    use_cpu_graphs(monkeypatch, Failing)
    trainer = _trainer()
    ddt = _graphed(trainer)
    start = trainer.init_state(seed=0)
    made = Failing.made
    with pytest.warns(RuntimeWarning, match="served eagerly"):
        got = _steps(ddt, start, torch.Generator().manual_seed(5), MOSAIC[:4])
    want = _steps(DeviceDataTrainer(trainer, _dataset(), None, jitter=JITTER), start,
                  torch.Generator().manual_seed(5), MOSAIC[:4])
    assert Failing.made == made + 1 and ddt.graphs.failures == 1
    assert all(g.counts["train.replay"] == 0 for g in got)
    assert all(_equal((g.state, g.metrics), (w.state, w.metrics)) and torch.equal(g.gen, w.gen)
               for g, w in zip(got, want))


@pytest.mark.parametrize("mesh", [None, ["cpu", "cpu"]], ids=["cpu", "mesh"])
def test_a_cpu_or_mesh_trainer_never_captures(mesh, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU or mesh step made a graph")

    use_cpu_graphs(monkeypatch, refuse)
    trainer = _trainer(mesh=mesh)
    ddt = DeviceDataTrainer(trainer, _dataset(), None, jitter=JITTER)
    assert ddt.graphs is None
    gen = torch.Generator().manual_seed(1)
    got = _steps(ddt, trainer.init_state(seed=0), gen, MOSAIC[:3])
    assert all(g.counts["train.replay"] == 0 and g.counts["train.step"] == 1 for g in got)


def test_graph_share_reads_replays_over_the_window_steps(monkeypatch):
    read = registry.metric_reader("graph_share.train")
    timer = StageTimer()
    monkeypatch.setattr(profiling, "_PROCESS", timer)
    run = SimpleNamespace(cell=SimpleNamespace(spans={}, counters={"steps": 4}), window_s=1.0)
    for _ in range(6):
        timer.add("train.step", 0.1)
    # A program without the span: nothing to read, and no error.
    assert read(run) is None
    for _ in range(3):
        timer.add("train.replay", 0.01)
    assert read(run) == pytest.approx(75.0)
    run.cell.counters["steps"] = 3
    assert read(run) == 100.0
    run.cell.counters["steps"] = 0
    assert read(run) is None
