"""The fused train-mode BatchNorm and activation (``csrc/batchnorm_act.cu``)
on the card.

They skip without a card. On the machine with one, run them without the
JAX test configuration (this file imports neither jax nor vbt_tpu):

    python -m pytest --noconftest -m cuda tests/test_torch_batchnorm_act_card.py

- At BatchNorm shapes of lite0 (320 px, B = 64) and D3 (896 px, B = 8):
  the largest plane, the 3 x 3 level and planes whose H x W is not a
  multiple of 4, for each activation: y, the batch mean and variance, the
  running statistics and the gradients of x, the weight and the bias
  against autograd of the plain version in float64 on the same inputs
  (ReLU6's mask taken from the kernels' y, so that a pre-activation within
  float32 rounding of 0 or 6 falls on the same side). Bounds: float32
  rounding of the kernels' own arithmetic; y, dx, dw and db within 1e-5 of
  the largest value of their kind, the statistics 1e-6 relative. Against
  the plain version in float32: y, the statistics, 1/std and the running
  statistics bit for bit (the kernels take its reductions and repeat its
  roundings); its gradients' gaps are printed beside the kernels'.
- A CUDA-graph replay of forward and backward equals eager launches bit
  for bit, the running statistics included.
- Two lite0 train steps through ``DeviceDataTrainer`` (the second a graph
  replay) against the same steps with every BatchNorm on the plain path,
  within ``lite0.train``'s limits (``benchmark/limits/lite0.train.json``):
  the loss, the first gradient (the momentum trace), the change of the
  parameters, of their EMA and of the running statistics. The same two
  steps by the whole program in float64 are printed beside them, against
  the plain float32 steps: how far the exact step lies from the float32
  one, the reading the cell's limits are judged against.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"lite0 160x160": (64, 96, 160, 160), "lite0 3x3": (64, 64, 3, 3),
          "lite0 5x5": (64, 64, 5, 5), "d3 448x448": (8, 144, 448, 448),
          "d3 7x7": (8, 160, 7, 7)}
ACTS = ("none", "relu6", "swish")
ACT_FNS = {"none": None, "relu6": F.relu6, "swish": F.silu}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield torch.device("cuda", 0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _case(shape, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=gen, device=dev) * 2 + 0.5
    dy = torch.randn(shape, generator=gen, device=dev)
    w = torch.rand(c, generator=gen, device=dev) * 3 + 0.5
    b = torch.rand(c, generator=gen, device=dev) * 2 - 1
    rm = torch.rand(c, generator=gen, device=dev)
    rv = torch.rand(c, generator=gen, device=dev) + 0.5
    return x, dy, w, b, rm, rv


def _reference(x, dy, w, b, rm, rv, act, y_kernel):
    """Autograd of the plain version in float64: (y, mean, var, running
    mean, running var, (dx, dw, db)); ReLU6's mask from ``y_kernel``."""
    from vbt_tpu_torch.ops import batchnorm_act as bn_ops

    x64, w64, b64 = (t.double().requires_grad_(True) for t in (x, w, b))
    rm64, rv64 = rm.double(), rv.double()
    pre = bn_ops.batchnorm_act_plain(x64, w64, b64, rm64, rv64)
    if act == "relu6":
        y = F.relu6(pre)
        mask = ((y_kernel > 0) & (y_kernel < 6)).double()
        grads = torch.autograd.grad(pre, (x64, w64, b64), dy.double() * mask)
    else:
        y = pre if act == "none" else ACT_FNS[act](pre)
        grads = torch.autograd.grad(y, (x64, w64, b64), dy.double())
    xd = x.double()
    mean = xd.mean(dim=(0, 2, 3))
    var = torch.clamp((xd * xd).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    return y.detach(), mean, var, rm64, rv64, grads


def _gap(got, want):
    """Largest gap over the largest value of ``want``."""
    return ((got.double() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernels_equal_the_plain_version(dev, shape, act):
    from vbt_tpu_torch.ops import batchnorm_act as bn_ops

    x, dy, w, b, rm, rv = _case(SHAPES[shape], dev)
    rm_k, rv_k = rm.clone(), rv.clone()
    launches = dict(bn_ops.batchnorm_act.launches)
    y, stats = bn_ops._forward(x, w, b, rm_k, rv_k, ACT_FNS[act])
    dx, dw, db = bn_ops._backward(x, dy, w, b, stats, ACT_FNS[act])
    torch.cuda.synchronize()
    assert bn_ops.batchnorm_act.launches == {k: n + 1 for k, n in launches.items()}
    want_y, mean, var, want_rm, want_rv, (want_dx, want_dw, want_db) = _reference(
        x, dy, w, b, rm, rv, act, y)
    gaps = {"y": _gap(y, want_y), "dx": _gap(dx, want_dx), "dw": _gap(dw, want_dw),
            "db": _gap(db, want_db)}
    # The plain version in float32 on the same inputs: the forward bit for
    # bit; its gradients' gaps printed beside the kernels'.
    xp, wp, bp = (t.clone().requires_grad_(True) for t in (x, w, b))
    rm_p, rv_p = rm.clone(), rv.clone()
    yp = bn_ops.batchnorm_act_plain(xp, wp, bp, rm_p, rv_p, ACT_FNS[act])
    plain = dict(zip(("dx", "dw", "db"), torch.autograd.grad(yp, (xp, wp, bp), dy)))
    print(f"{shape} {act}: kernels {gaps}; plain float32 y {_gap(yp.detach(), want_y):.2e}, "
          + ", ".join(f"{k} {_gap(v, w_):.2e}" for (k, v), w_ in
                      zip(plain.items(), (want_dx, want_dw, want_db))))
    assert all(g <= 1e-5 for g in gaps.values()), gaps
    same = y == yp.detach()
    assert same.all(), f"y: {int((~same).sum())} of {y.numel()} differ from the plain version's"
    mean32 = x.mean(dim=(0, 2, 3))
    var32 = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean32 * mean32, min=0.0)
    assert torch.equal(stats[0], mean32) and torch.equal(stats[1], var32)
    assert torch.equal(stats[2], torch.rsqrt(var32 + 1e-3))
    assert torch.equal(rm_k, rm_p) and torch.equal(rv_k, rv_p)
    torch.testing.assert_close(stats[0].double(), mean, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(stats[1].double(), var, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(stats[2].double(), 1 / torch.sqrt(var + 1e-3), rtol=1e-6, atol=0)
    assert (stats[3] == 1).all()
    torch.testing.assert_close(rm_k.double(), want_rm, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(rv_k.double(), want_rv, rtol=1e-6, atol=1e-7)
    if act == "relu6":
        assert (y == 0).any() and (y == 6).any() and ((y > 0) & (y < 6)).any()


def test_a_constant_channel_clamps_the_variance(dev):
    """A channel of one value: its variance 0, y and dx as the reference's."""
    from vbt_tpu_torch.ops import batchnorm_act as bn_ops

    x, dy, w, b, rm, rv = _case((8, 16, 5, 5), dev)
    x[:, 3] = 2.3
    y, stats = bn_ops._forward(x, w, b, rm, rv, F.relu6)
    dx, dw, db = bn_ops._backward(x, dy, w, b, stats, F.relu6)
    assert stats[1, 3] == 0 and torch.isfinite(dx).all()
    want_y, _, _, _, _, (want_dx, want_dw, _) = _reference(
        x, dy, w, b, rm.clone(), rv.clone(), "relu6", y)
    assert _gap(y, want_y) <= 1e-5 and _gap(dx, want_dx) <= 1e-5 and _gap(dw, want_dw) <= 1e-5


@pytest.mark.parametrize("act", ACTS)
def test_a_graph_replay_equals_eager_launches_bit_for_bit(dev, act):
    from vbt_tpu_torch.ops import batchnorm_act as bn_ops

    x, dy, w, b, rm, rv = _case((16, 64, 40, 40), dev, seed=1)
    w, b = w.requires_grad_(True), b.requires_grad_(True)
    run_rm, run_rv = rm.clone(), rv.clone()

    def fn():
        xx = x.detach().requires_grad_(True)
        y = bn_ops.batchnorm_act(xx, w, b, run_rm, run_rv, ACT_FNS[act])
        return (y, *torch.autograd.grad(y, (xx, w, b), dy))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    run_rm.copy_(rm)
    run_rv.copy_(rv)
    launches = dict(bn_ops.batchnorm_act.launches)
    graph.replay()
    torch.cuda.synchronize()
    assert bn_ops.batchnorm_act.launches == launches  # a raw replay counts nothing
    got = [t.clone() for t in out] + [run_rm.clone(), run_rv.clone()]
    run_rm.copy_(rm)
    run_rv.copy_(rv)
    want = list(fn()) + [run_rm.clone(), run_rv.clone()]
    torch.cuda.synchronize()
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))


def _limits():
    with open(os.path.join(REPO, "benchmark", "limits", "lite0.train.json")) as f:
        return json.load(f)


def _leaf_gap(prog: dict, ref: dict, keys) -> float:
    """``lite0.train``'s rule: the worst leaf's |norm(prog) - norm(ref)| over
    max(norm(ref), the median leaf's norm of ref)."""
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in keys}
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = float(np.median(list(rn.values())))
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys)


def _step_gaps(got, want, start) -> dict:
    """``lite0.train``'s gaps of two steps ``got`` against ``want`` (each
    (losses, first trace, state)) from ``start``, leaves of the first
    gradient under 1e-3 of the median's left out as the cell leaves them."""
    (g_loss, g_grad, g_state), (w_loss, w_grad, w_state) = got, want
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in w_grad.items()}
    med = float(np.median(list(norms.values())))
    moved = [k for k in w_grad if norms[k] >= 1e-3 * med]

    def change(state, name):
        return {k: getattr(state, name)[k].double() - getattr(start, name)[k].double()
                for k in getattr(start, name)}

    def gap(name, keys):
        return _leaf_gap(change(g_state, name), change(w_state, name), keys)

    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(g_loss, w_loss)),
            "grad_gap": _leaf_gap(g_grad, w_grad, moved),
            "change_gap": gap("params", moved), "ema_gap": gap("ema_params", moved),
            "stats_gap": gap("batch_stats", list(start.batch_stats))}


def test_a_graphed_lite0_step_equals_the_plain_paths_within_the_cells_limits(dev, monkeypatch):
    """Also prints the reading a limit of ``lite0.train`` is judged against:
    the same steps by the whole program in float64 (every BatchNorm plain),
    against the plain float32 steps."""
    from vbt_tpu_torch.io.synthetic import plate_boxes, plate_frames
    from vbt_tpu_torch.models import get_model_spec
    from vbt_tpu_torch.models.conv import BatchNorm
    from vbt_tpu_torch.ops import batchnorm_act as bn_ops
    from vbt_tpu_torch.train.data import DetectionDataset
    from vbt_tpu_torch.train.fused import DeviceDataTrainer
    from vbt_tpu_torch.train.train_step import Trainer

    n, size, batch = 32, 320, 16
    boxes, valid = np.zeros((n, 16, 4), np.float32), np.zeros((n, 16), bool)
    boxes[:, 0], valid[:, 0] = plate_boxes(n, size, size, period=9), True
    data = DetectionDataset(plate_frames(n, size, size, seed=4, period=9), boxes, valid,
                            [str(i) for i in range(n)])
    order = np.random.default_rng(5).permutation(n)

    def trainer(dtype=torch.float32):
        return Trainer(get_model_spec("efficientdet_lite0"), base_lr=0.08 * batch / 64,
                       total_steps=20, warmup_steps=2, dtype=dtype, device=dev)

    start = trainer().init_state(seed=0)

    def run(t, graphed=True):
        ddt = DeviceDataTrainer(t, data)
        gen = torch.Generator(device=dev).manual_seed(9)
        state, losses, traces = t.init_state(seed=0), [], []
        for i in range(2):  # eager, then captured and replayed where graphed
            idx = torch.as_tensor(order[i * batch:(i + 1) * batch], device=dev)
            state, metrics = ddt.step(state, idx, gen, 0.5)
            losses.append(float(metrics["loss"]))
            traces.append({k: v.clone() for k, v in state.opt_state.trace.items()})
        if graphed:
            assert ddt.graphs.failures == 0 and len(ddt.graphs.graphs) == 1
        return losses, traces[0], state

    t32 = trainer()
    calls = dict(BatchNorm.train_calls)
    fused = run(t32)
    n_bn = sum(isinstance(m, BatchNorm) for m in t32.model.modules())
    assert BatchNorm.train_calls["fused"] - calls["fused"] == 2 * n_bn  # eager + replay
    assert BatchNorm.train_calls["card"] - calls["card"] == 2 * n_bn
    calls = dict(BatchNorm.train_calls)
    program64 = run(trainer(torch.float64), graphed=False)
    assert BatchNorm.train_calls["fused"] == calls["fused"]
    monkeypatch.setattr(bn_ops, "KERNEL_DEVICE", "no card")  # every BatchNorm plain
    calls = dict(BatchNorm.train_calls)
    plain = run(trainer())
    assert BatchNorm.train_calls == calls

    limits = _limits()
    gaps = _step_gaps(fused, plain, start)
    reading = _step_gaps(program64, plain, start)
    print("fused against plain:", gaps)
    print("the float64 program against plain float32 (a reading, not held):", reading)
    assert all(np.isfinite(v) for v in reading.values()), reading
    assert all(gaps[k] <= limits[k] for k in gaps), (gaps, limits)
