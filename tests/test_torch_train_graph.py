"""The device-resident train step served from a CUDA graph, on the card
(``runtime/graphs.py``, ``DeviceDataTrainer.step``).

They skip without a card. On the machine with one, run them without the
JAX test configuration (this file imports neither jax nor vbt_tpu):

    python -m pytest --noconftest -m cuda tests/test_torch_train_graph.py

For lite0 (320 px, B = 16) and two small D specs (the B3 backbone with
squeeze-excite and swish, BiFPN 16 x 2 with fast fusion, 128 px, B = 4; the
B0 backbone with D7x's six-level BiFPN, P3-P8, and sum fusion, likewise),
random-init weights, from one state, the same index batches and generator
seed, with ``cudnn.deterministic`` on: six graphed steps (eager on the
trainer's stream, the capture and its first replay, four replays,
``mosaic_p`` 0 on the last) against six eager steps. Losses, parameters, momentum trace, EMA and
running statistics are equal bit for bit after every step, and so is the
generator's state. Once the graphed trainer is deleted,
``torch.cuda.memory_allocated()`` is back within 1% of its value before
it was built (both read with cuBLAS's per-stream workspaces cleared: the
graph's stream adds one, a cache of the process and not the trainer's).
"""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

STEPS = 6
MOSAIC = [0.5] * (STEPS - 1) + [0.0]
SPECS = {"lite0": (None, 16), "small_d": (("small_d", "b3", 128, 16, 2, 2), 4),
         "small_d7x": (("small_d7x", "b0", 128, 16, 2, 2), 4)}
# The small D specs' fusion and pyramid: D3's, and D7x's six levels with sums.
D_KWARGS = {"small_d": dict(fusion="fastattn"), "small_d7x": dict(fusion="sum", max_level=8)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _allocated(dev) -> int:
    torch.cuda.synchronize()
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(dev)


def _spec(name):
    from vbt_tpu_torch.models import ModelSpec, get_model_spec

    args, _ = SPECS[name]
    if args is None:
        return get_model_spec("efficientdet_lite0")
    return ModelSpec(*args, anchor_scale=4.0, act="swish", **D_KWARGS[name])


def _dataset(size, n=32):
    from vbt_tpu_torch.io.synthetic import plate_boxes, plate_frames
    from vbt_tpu_torch.train.data import DetectionDataset

    boxes, valid = np.zeros((n, 16, 4), np.float32), np.zeros((n, 16), bool)
    boxes[:, 0], valid[:, 0] = plate_boxes(n, size, size, period=9), True
    return DetectionDataset(plate_frames(n, size, size, seed=4, period=9), boxes, valid,
                            [str(i) for i in range(n)])


def _tensors(state, metrics):
    return ([*state.params.values(), *state.batch_stats.values(),
             *state.opt_state.trace.values(), *state.ema_params.values()]
            + [metrics[k] for k in ("loss", "cls_loss", "box_loss", "num_pos")])


def _run(ddt, state, dev, batch):
    """Each step's tensors (copied to the host) and the generator's state
    after it."""
    gen = torch.Generator(device=dev).manual_seed(9)
    order = np.random.default_rng(5).permutation(32)
    out = []
    for i, p in enumerate(MOSAIC):
        idx = torch.as_tensor(order[(i * batch) % 32:(i * batch) % 32 + batch], device=dev)
        state, metrics = ddt.step(state, idx, gen, p)
        out.append(([t.cpu() for t in _tensors(state, metrics)], gen.get_state(),
                    (state.step, state.opt_state.count, metrics["lr"])))
    return out


@pytest.mark.parametrize("name", sorted(SPECS))
def test_graphed_steps_equal_eager_steps_bit_for_bit(name, dev):
    from vbt_tpu_torch.runtime.graphs import Graph
    from vbt_tpu_torch.train.fused import DeviceDataTrainer
    from vbt_tpu_torch.train.train_step import Trainer
    from vbt_tpu_torch.utils.profiling import StageTimer

    spec = _spec(name)
    batch = SPECS[name][1]
    data = _dataset(spec.input_size)
    trainer = Trainer(spec, base_lr=0.01, total_steps=20, warmup_steps=2, device=dev)
    start = trainer.init_state(seed=0)

    eager = DeviceDataTrainer(trainer, data)
    eager.graphs = None
    want = _run(eager, start, dev, batch)
    del eager
    before = _allocated(dev)

    ddt = DeviceDataTrainer(trainer, data)
    timer = StageTimer()
    with timer.stage("steps"):
        got = _run(ddt, start, dev, batch)
    graphs = list(ddt.graphs.graphs.values())  # one key at a time
    assert len(graphs) == 1 and isinstance(graphs.pop(), Graph) and ddt.graphs.failures == 0
    assert timer.counts["train.replay"] == STEPS - 1
    for i, ((g, g_gen, g_host), (w, w_gen, w_host)) in enumerate(zip(got, want)):
        assert g_host == w_host, i
        assert torch.equal(g_gen, w_gen), i
        bad = [j for j, (a, b) in enumerate(zip(g, w)) if not torch.equal(a, b)]
        assert not bad, (i, len(bad), len(g))

    del ddt
    after = _allocated(dev)
    assert abs(after - before) <= 0.01 * before, (before, after)
