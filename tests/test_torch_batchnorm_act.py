"""The fused train-mode BatchNorm and activation (``ops/batchnorm_act.py``,
``csrc/batchnorm_act.cu``) on the CPU: its algorithm, its dispatch, its
counters and its launch plan.

- The kernels' math written out in torch (:func:`oracle_forward`: the
  mean and mean of squares, then the fast variance and normalize-and-activate;
  :func:`oracle_backward`: z again, dz, the sums of dz and dz * xhat, then
  the closed form of dx) against autograd of the plain version in float64,
  for each activation (ReLU6 with pre-activations exactly on 0, exactly on
  6 and past both), a channel held constant where the variance's clamp
  engages, and planes of 9, 25 and 1600 elements.
- The dispatch in ``models/conv.py::BatchNorm``, with a fake binding that
  runs the oracle in the kernels' place and the CPU standing in for the
  card (``KERNEL_DEVICE``): train-mode float32 calls with no
  ``reduce_stats`` take :class:`BatchNormAct`, with the activation of
  ``BatchNormAct`` and ``PredictionHead`` inside it (another activation
  takes the plain version), and every BatchNorm of a model does; eval mode, float64, bfloat16, a set ``reduce_stats`` and the
  CPU itself run the code that was there before, bit for bit.
- The counters (``BatchNorm.train_calls``, ``batchnorm_act.launches``)
  register themselves, a graph's capture leaves them and a replay advances
  them (``tests/torch_cpu_graph.py``); ``bn_fused_share.train`` reads fused
  calls over the card's train-mode calls, and nothing from a program
  without the counter.
- :func:`launch_plan` at lite0's and D3's BatchNorm shapes.
"""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from torch_cpu_graph import CpuGraph  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

from benchmark.core import registry  # noqa: E402
from vbt_tpu_torch.models.conv import BatchNorm  # noqa: E402
from vbt_tpu_torch.models.efficientnet_lite import BatchNormAct as BatchNormActModule  # noqa: E402
from vbt_tpu_torch.models.heads import PredictionHead  # noqa: E402
from vbt_tpu_torch.ops import batchnorm_act as bn_ops  # noqa: E402
from vbt_tpu_torch.utils.profiling import launch_counts  # noqa: E402

EPS, MOMENTUM = 1e-3, 0.99
ACT_FNS = {"none": None, "relu6": F.relu6, "swish": F.silu}
ACT_NAMES = {fn: name for name, fn in ACT_FNS.items()}
CONSTANTS = (2.3, 0.2, 0.3, 3.7, 5.1, 1.1)  # one of them makes mean(x^2) - mean^2 < 0


def _act(z, act):
    return {"none": lambda t: t, "relu6": F.relu6, "swish": F.silu}[act](z)


def oracle_forward(x, w, b, act, mean=None, meansq=None):
    """The forward's math: the batch's mean and mean of squares (the plain
    version's reductions, or the ones given); the fast variance (its clamp's
    gate: 1 where the raw value is >= 0), 1/std, and in one pass
    act(((x - mean) * (invstd * w)) + b)."""
    mean = x.mean(dim=(0, 2, 3)) if mean is None else mean
    meansq = (x * x).mean(dim=(0, 2, 3)) if meansq is None else meansq
    raw = meansq - mean * mean
    gate = (raw >= 0).to(x.dtype)
    var = torch.where(raw < 0, torch.zeros_like(raw), raw)
    invstd = 1 / torch.sqrt(var + EPS)
    z = (x - mean[:, None, None]) * (invstd * w)[:, None, None] + b[:, None, None]
    return SimpleNamespace(y=_act(z, act), mean=mean, var=var, invstd=invstd, gate=gate)


def oracle_backward(x, dy, w, b, mean, invstd, gate, act):
    """The backward kernels' math: z again; dz = dy * act'(z) (ReLU6: the mask
    0 < z < 6; swish: s (1 + z (1 - s))); pass 1 the sums of dz and
    dz * xhat; pass 2 dx = invstd w (dz - sum(dz)/M - gate xhat sum(dz xhat)/M).
    Returns (dx, dw, db)."""
    m = x.shape[0] * x.shape[2] * x.shape[3]
    c = lambda t: t[:, None, None]  # noqa: E731
    u = x - c(mean)
    z = u * c(invstd * w) + c(b)
    if act == "relu6":
        dz = dy * ((z > 0) & (z < 6)).to(x.dtype)
    elif act == "swish":
        s = torch.sigmoid(z)
        dz = dy * s * (1 + z * (1 - s))
    else:
        dz = dy
    xhat = u * c(invstd)
    sdz, sdzx = dz.sum(dim=(0, 2, 3)), (dz * xhat).sum(dim=(0, 2, 3))
    dx = c(invstd * w) * (dz - c(sdz / m) - c(gate) * xhat * c(sdzx / m))
    return dx, sdzx, sdz


def _inputs(hw, act, constant=False, dtype=torch.float64, seed=0):
    """(x, w, b, dy) of 2 images and 6 channels, planes of ``hw``; for ReLU6
    channel 1 has weight 0 and bias 0 (every z exactly 0), channel 2 weight
    0 and bias 6 (exactly 6), the rest weights wide enough to pass both
    ends; with ``constant`` channel 0 holds one value, chosen so that the
    raw variance rounds below 0."""
    gen = torch.Generator().manual_seed(seed)
    n, c = 2, 6
    x = torch.randn(n, c, 1, hw, generator=gen, dtype=torch.float64) * 1.7 + 0.4
    w = torch.linspace(0.5, 4.0, c, dtype=torch.float64)
    b = torch.linspace(-1.0, 3.0, c, dtype=torch.float64)
    if act == "relu6":
        w[1], b[1], w[2], b[2] = 0.0, 0.0, 0.0, 6.0
    if constant:
        def engages(v):
            t = torch.full((n, 1, 1, hw), v, dtype=torch.float64)
            mean = t.mean(dim=(0, 2, 3))
            return float((t * t).mean(dim=(0, 2, 3)) - mean * mean) < 0

        x[:, 0] = next(v for v in CONSTANTS if engages(v))
    dy = torch.randn(x.shape, generator=gen, dtype=torch.float64)
    return tuple(t.to(dtype) for t in (x, w, b, dy))


def _plain_autograd(x, w, b, dy, act, rm=None, rv=None):
    c = x.shape[1]
    x, w, b = (t.clone().requires_grad_(True) for t in (x, w, b))
    rm = torch.zeros(c, dtype=x.dtype) if rm is None else rm
    rv = torch.ones(c, dtype=x.dtype) if rv is None else rv
    y = bn_ops.batchnorm_act_plain(x, w, b, rm, rv, ACT_FNS[act])
    dx, dw, db = torch.autograd.grad(y, (x, w, b), dy)
    return y.detach(), dx, dw, db, rm, rv


CASES = [(act, hw, False) for act in ("none", "relu6", "swish") for hw in (9, 25, 1600)]
CASES += [(act, hw, True) for act, hw in (("none", 9), ("relu6", 25), ("swish", 1600))]


@pytest.mark.parametrize("act,hw,constant", CASES,
                         ids=[f"{a}-{h}{'-constant' if k else ''}" for a, h, k in CASES])
def test_the_kernels_math_equals_autograd_of_the_plain_version(act, hw, constant):
    x, w, b, dy = _inputs(hw, act, constant)
    want_y, want_dx, want_dw, want_db, rm, rv = _plain_autograd(x, w, b, dy, act)
    got = oracle_forward(x, w, b, act)
    dx, dw, db = oracle_backward(x, dy, w, b, got.mean, got.invstd, got.gate, act)
    tol = dict(rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(got.y, want_y, **tol)
    torch.testing.assert_close(0.99 * torch.zeros(6, dtype=x.dtype) + 0.01 * got.mean, rm, **tol)
    torch.testing.assert_close(0.99 * torch.ones(6, dtype=x.dtype) + 0.01 * got.var, rv, **tol)
    torch.testing.assert_close(dx, want_dx, **tol)
    torch.testing.assert_close(dw, want_dw, **tol)
    torch.testing.assert_close(db, want_db, **tol)
    if constant:
        assert got.gate[0] == 0 and got.var[0] == 0 and got.gate[1:].all()
    if act == "relu6":  # pre-activations exactly on 0 and on 6 take no gradient
        z = lambda ch: (x[:, ch] - got.mean[ch]) * got.invstd[ch] * w[ch] + b[ch]  # noqa: E731
        assert (z(1) == 0).all() and (z(2) == 6).all()
        assert (want_dx[:, 1:3] == 0).all() and (dx[:, 1:3] == 0).all()
        assert (got.y > 0).any() and (got.y == 6).any() and (got.y == 0).any()


# ---- the dispatch, with a fake binding ----


def _old_batchnorm_train(bn, x):
    """``BatchNorm.forward`` in train mode as it was before the kernels."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if bn.reduce_stats is None:
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    else:
        mean, var = bn.reduce_stats(xf)
    with torch.no_grad():
        bn.running_mean.copy_(MOMENTUM * bn.running_mean + (1 - MOMENTUM) * mean)
        bn.running_var.copy_(MOMENTUM * bn.running_var + (1 - MOMENTUM) * var)
    mul = torch.rsqrt(var + EPS) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    return y.to(x.dtype)


@pytest.fixture
def fake_card(monkeypatch):
    """The CPU in the card's place, and the oracle in the kernels' (in
    float64, rounded into the kernels' float32 outputs); returns the list of
    (direction, activation's name, plan) the fake binding was called with."""
    calls = []

    def forward(x, mean, meansq, weight, bias, running_mean, running_var, y, stats, plan, act):
        act = ACT_NAMES[act]
        calls.append(("forward", act, plan))
        assert torch.equal(mean, x.mean(dim=(0, 2, 3)))  # the plain version's reductions
        assert torch.equal(meansq, (x * x).mean(dim=(0, 2, 3)))
        got = oracle_forward(x.double(), weight.double(), bias.double(), act, mean.double(),
                             meansq.double())
        y.copy_(got.y)
        stats.copy_(torch.stack([got.mean, got.var, got.invstd, got.gate]))
        running_mean.copy_(MOMENTUM * running_mean + (1 - MOMENTUM) * stats[0])
        running_var.copy_(MOMENTUM * running_var + (1 - MOMENTUM) * stats[1])

    def backward(x, dy, weight, bias, stats, partial, dx, dw, db, plan, act):
        act = ACT_NAMES[act]
        calls.append(("backward", act, plan))
        assert partial.shape == (x.shape[1] * plan[4], 2) and partial.dtype == torch.float64
        mean, _, invstd, gate = stats.double()
        for out, got in zip((dx, dw, db), oracle_backward(x.double(), dy.double(), weight.double(),
                                                          bias.double(), mean, invstd, gate, act)):
            out.copy_(got)

    monkeypatch.setattr(bn_ops, "KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(bn_ops, "_sms", lambda device: 132)
    monkeypatch.setattr(bn_ops, "_launch_forward", forward)
    monkeypatch.setattr(bn_ops, "_launch_backward", backward)
    return calls


def _bn(c=6, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c).to(dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=gen) + 0.5)
        bn.bias.copy_(torch.rand(c, generator=gen) - 0.5)
        bn.running_mean.copy_(torch.rand(c, generator=gen))
        bn.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return bn.train()


def _counters():
    return dict(BatchNorm.train_calls), dict(bn_ops.batchnorm_act.launches)


@pytest.mark.parametrize("act", ["none", "relu6", "swish"])
def test_train_mode_float32_on_the_card_takes_the_function(fake_card, act):
    x, _, _, dy = _inputs(25, act, dtype=torch.float32)
    x = x.requires_grad_(True)
    bn, ref = _bn(), _bn()
    calls, kernels = _counters()
    y = bn(x, ACT_FNS[act])
    assert type(y.grad_fn).__name__ == "BatchNormActBackward"
    assert fake_card == [("forward", act, (2, 6, 25, 1, 1))]
    got = torch.autograd.grad(y, (x, bn.weight, bn.bias), dy)
    assert [c[:2] for c in fake_card] == [("forward", act), ("backward", act)]
    assert _counters() == ({"card": calls["card"] + 1, "fused": calls["fused"] + 1},
                           {k: n + 1 for k, n in kernels.items()})
    # The plain version from the same module state, in float32.
    xr = x.detach().clone().requires_grad_(True)
    want = bn_ops.batchnorm_act_plain(xr, ref.weight, ref.bias, ref.running_mean,
                                      ref.running_var, ACT_FNS[act])
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    for g, w in zip(got, torch.autograd.grad(want, (xr, ref.weight, ref.bias), dy)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    for name in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(bn, name), getattr(ref, name), rtol=1e-6, atol=1e-6)


def test_modules_hand_their_activation_to_the_kernels(fake_card):
    bna = BatchNormActModule(6, F.relu6).train()
    bna.bn.load_state_dict(_bn().state_dict())
    bna(torch.randn(2, 6, 4, 4))
    head = PredictionHead(4, 3, 6, 1, act=F.silu).train()
    for m in head.modules():
        if isinstance(m, BatchNorm):
            m.load_state_dict(_bn().state_dict())
    with torch.no_grad():
        for p in head.parameters():
            if p.dim() == 4:
                p.copy_(torch.randn(p.shape) * 0.1)
    head({lv: torch.randn(2, 6, s, s) for lv, s in zip(range(3, 8), (8, 4, 2, 1, 1))})
    assert [c[1] for c in fake_card] == ["relu6"] + ["swish"] * 5
    fake_card.clear()
    tanh = BatchNormActModule(6, torch.tanh).train()  # an activation the kernels lack
    tanh.bn.load_state_dict(_bn().state_dict())
    x = torch.randn(2, 6, 4, 4)
    ref = _bn()
    before = dict(BatchNorm.train_calls)
    assert torch.equal(tanh(x), torch.tanh(_old_batchnorm_train(ref, x)))  # the plain version
    assert fake_card == []
    assert BatchNorm.train_calls == {"card": before["card"] + 1, "fused": before["fused"]}


def test_every_batchnorm_of_a_model_takes_the_kernels(fake_card):
    from vbt_tpu_torch.models import get_model_spec
    from vbt_tpu_torch.models.efficientdet import EfficientDet, init_parameters

    model = EfficientDet(get_model_spec("efficientdet_lite0"))
    init_parameters(model, torch.Generator().manual_seed(0))
    model.train()
    card, fused = BatchNorm.train_calls["card"], BatchNorm.train_calls["fused"]
    with torch.no_grad():
        model(torch.randn(1, 3, 64, 64))
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    assert BatchNorm.train_calls == {"card": card + n_bn, "fused": fused + n_bn}
    acts = [c[1] for c in fake_card]
    assert len(acts) == n_bn == 106 and set(acts) == {"none", "relu6"}


def _plain_cases():
    x = torch.randn(2, 6, 5, 5, generator=torch.Generator().manual_seed(3))

    def stats(xf):
        return xf.mean(dim=(0, 2, 3)) * 0.5, xf.var(dim=(0, 2, 3))

    return {"float64": (x.double(), None), "bfloat16": (x.bfloat16(), None),
            "float32 with reduce_stats": (x, stats)}


@pytest.mark.parametrize("case", list(_plain_cases()))
@pytest.mark.parametrize("card", [True, False], ids=["card", "cpu"])
def test_other_calls_run_the_code_that_was_there_before(case, card, request):
    calls = request.getfixturevalue("fake_card") if card else []
    x, stats = _plain_cases()[case]
    for act in (None, F.relu6, F.silu):
        dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
        bn, ref = _bn(dtype=dtype), _bn(dtype=dtype)
        bn.reduce_stats = ref.reduce_stats = stats
        before = dict(BatchNorm.train_calls)
        got = bn(x, act)
        want = _old_batchnorm_train(ref, x)
        want = want if act is None else act(want)
        assert got.dtype == want.dtype and torch.equal(got, want)
        for name in ("running_mean", "running_var"):
            assert torch.equal(getattr(bn, name), getattr(ref, name))
        assert BatchNorm.train_calls == {"card": before["card"] + card, "fused": before["fused"]}
        eval_bn, eval_ref = _bn(dtype=bn.weight.dtype).eval(), _bn(dtype=bn.weight.dtype).eval()
        xe = x.to(bn.weight.dtype)
        want = F.batch_norm(xe, eval_ref.running_mean, eval_ref.running_var, eval_ref.weight,
                            eval_ref.bias, training=False, eps=EPS)
        assert torch.equal(eval_bn(xe, act), want if act is None else act(want))
        assert BatchNorm.train_calls == {"card": before["card"] + card, "fused": before["fused"]}
    assert calls == []


def test_float32_on_the_cpu_runs_the_code_that_was_there_before():
    x = torch.randn(2, 6, 5, 5, generator=torch.Generator().manual_seed(4))
    bn, ref = _bn(), _bn()
    before = dict(BatchNorm.train_calls)
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got, want = bn(xa, F.relu6), F.relu6(_old_batchnorm_train(ref, xb))
    assert torch.equal(got, want) and BatchNorm.train_calls == before
    dy = torch.randn(x.shape)
    for g, w in zip(torch.autograd.grad(got, (xa, bn.weight, bn.bias), dy),
                    torch.autograd.grad(want, (xb, ref.weight, ref.bias), dy)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):  # the kernels' wrapper takes no CPU tensor
        bn_ops.batchnorm_act(x, ref.weight, ref.bias, ref.running_mean, ref.running_var)


def test_the_wrapper_refuses_what_the_kernels_do_not_take(fake_card):
    bn = _bn()
    args = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    with pytest.raises(TypeError):
        bn_ops.batchnorm_act(torch.zeros(2, 6, 3, 3, dtype=torch.float64), *args)
    with pytest.raises(ValueError):
        bn_ops.batchnorm_act(torch.zeros(2, 6, 9), *args)
    with pytest.raises(ValueError):
        bn_ops.batchnorm_act(torch.zeros(2, 6, 3, 3), *args, act="gelu")
    with pytest.raises(TypeError):
        bn_ops.batchnorm_act(torch.zeros(2, 5, 3, 3), *args)
    with pytest.raises(TypeError):
        bn_ops.batchnorm_act(torch.zeros(2, 6, 3, 3), bn.weight.double(), *args[1:])
    assert fake_card == []


# ---- the counters ----


def test_the_counters_register_themselves():
    counts = launch_counts()
    base = "vbt_tpu_torch.models.conv.BatchNorm.train_calls"
    for k in ("card", "fused"):
        assert counts[f"{base}[{k}]"] == BatchNorm.train_calls[k]
    kernels = "vbt_tpu_torch.ops.batchnorm_act.batchnorm_act.launches"
    for k in ("forward_apply", "backward_partials", "backward_apply"):
        assert counts[f"{kernels}[{k}]"] == bn_ops.batchnorm_act.launches[k]


def test_a_capture_leaves_the_counters_and_a_replay_advances_them(fake_card):
    bn = _bn()
    dy = torch.randn(2, 6, 4, 4)

    def step(inputs, scalars):
        x = inputs[0].requires_grad_(True)
        return torch.autograd.grad(bn(x, F.relu6), (x, bn.weight), dy)

    graph = CpuGraph([torch.randn(2, 6, 4, 4)], (), (), None)
    before = _counters()
    graph.capture(step)
    assert _counters() == before
    held = {k.rsplit(".", 1)[-1]: n for k, n in graph.launches.items() if n}
    assert held == {"train_calls[card]": 1, "train_calls[fused]": 1,
                    "launches[forward_apply]": 1,
                    "launches[backward_partials]": 1, "launches[backward_apply]": 1}
    graph.replay()
    graph.replay()
    calls, kernels = _counters()
    assert calls == {k: n + 2 for k, n in before[0].items()}
    assert kernels == {k: n + 2 for k, n in before[1].items()}


def test_bn_fused_share_reads_fused_calls_over_the_cards(monkeypatch):
    read = registry.metric_reader("bn_fused_share.train")
    run = SimpleNamespace(cell=SimpleNamespace(counters={"steps": 3}))
    monkeypatch.setattr(BatchNorm, "train_calls", {"card": 0, "fused": 0})
    assert read(run) is None  # nothing ran on the card
    monkeypatch.setattr(BatchNorm, "train_calls", {"card": 212, "fused": 212})
    assert read(run) == 100.0
    monkeypatch.setattr(BatchNorm, "train_calls", {"card": 200, "fused": 50})
    assert read(run) == 25.0
    monkeypatch.delattr(BatchNorm, "train_calls")  # a program without the counter
    assert read(run) is None


# ---- the launch plan ----

SMS = 132
# (N, C, H*W) of BatchNorms of lite0 at 320, B = 64 and of D3 at 896, B = 8:
# the largest planes, the smallest, planes whose H*W is not a multiple of 4,
# and the widest layers.
SHAPES = {"lite0 160x160": (64, 32, 160 * 160), "lite0 3x3": (64, 64, 3 * 3),
          "lite0 5x5": (64, 64, 5 * 5), "lite0 10x10 x 1152": (64, 1152, 10 * 10),
          "d3 448x448": (8, 40, 448 * 448), "d3 7x7": (8, 160, 7 * 7),
          "d3 28x28 x 1392": (8, 1392, 28 * 28)}


@pytest.mark.parametrize("name", list(SHAPES))
def test_the_launch_plan_fills_the_card_where_the_shape_can(name):
    n, c, hw = SHAPES[name]
    m = n * hw
    vec, split = bn_ops.launch_plan(n, c, hw, SMS, aligned=True)
    assert vec == (4 if hw % 4 == 0 else 1)
    assert bn_ops.launch_plan(n, c, hw, SMS, aligned=False) == (1, split)
    assert split == 1 or m // split >= bn_ops.MIN_BLOCK_ELEMENTS
    if c * (m // bn_ops.MIN_BLOCK_ELEMENTS) >= 2 * SMS:
        assert c * split >= 2 * SMS  # at least two blocks an SM where the elements allow
    if m >= bn_ops.BLOCK_ELEMENTS:
        assert m / split <= bn_ops.BLOCK_ELEMENTS  # large channels cut over N and H*W
