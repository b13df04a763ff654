"""The port's train step against the JAX package's, on the CPU.

Both sides start from JAX's initialised state converted into the port, take
three steps on one batch, and are compared leaf by leaf through the
checkpoint layout (``runtime.checkpoint.train_state_to_flax``), whole model
and heads-only. Those steps run in float64 on both sides (the JAX
``Trainer``'s ``dtype``, the test configuration's x64, and the port
``Trainer``'s ``dtype=torch.float64``); the losses take float32 logits on
both, as the JAX package casts them. In float32 the comparison could hold
nothing: train-mode BatchNorm over a small batch's few positions makes the
gradients ill-conditioned, and JAX's own float32 gradients differ from its
float64 ones by 10-20% of a leaf's largest value (measured at 64 px with
B = 2 and 4, and at 128 px). float32 training is held on the card against
the CPU port instead (``chip_smoke.py`` phase 13).

Tolerances: train-mode BatchNorm outputs and updated running statistics
within 1e-5, float32 (batch statistics reduced in another order); the
schedule within 1e-6 of the peak of optax's (both in float32; near the end
``1 + cos`` cancels and a last-bit difference of ``cos`` shows); one
float32 optimizer update within 1e-6 relative; the three steps' losses
within 1e-4 relative, as is the validation loss after them
(``eval_loss``), and every leaf of params, batch_stats, trace and EMA
within ``1e-5 + 1e-4 * max|JAX leaf|``; frozen params and statistics
unchanged bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import flax.linen as nn  # noqa: E402
import flax.serialization  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vbt_tpu.models import ModelSpec as JaxModelSpec  # noqa: E402
from vbt_tpu.train import train_step as jts  # noqa: E402
from vbt_tpu_torch.models import ModelSpec  # noqa: E402
from vbt_tpu_torch.models.conv import BatchNorm  # noqa: E402
from vbt_tpu_torch.runtime.checkpoint import (  # noqa: E402
    to_flax_variables,
    train_state_from_flax,
    train_state_to_flax,
)
from vbt_tpu_torch.train import train_step as tts  # noqa: E402

TINY = ("tiny", "lite0", 64, 32, 1, 1)
FREEZE = ("backbone", "fpn")
STEPS = 3
LR, TOTAL, WARMUP = 0.05, 10, 1


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_train_mode_batchnorm_matches_flax():
    rng = np.random.default_rng(0)
    c = 6
    x = rng.normal(3.0, 2.0, size=(4, 5, 7, c)).astype(np.float32)  # NHWC
    scale, bias = rng.normal(1, 0.2, c).astype(np.float32), rng.normal(0, 0.2, c).astype(np.float32)
    mean, var = rng.normal(0, 1, c).astype(np.float32), rng.uniform(0.5, 2, c).astype(np.float32)
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    want, upd = flax_bn.apply({"params": {"scale": scale, "bias": bias},
                               "batch_stats": {"mean": mean, "var": var}},
                              jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(c)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var)})
    bn.train()
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(), upd["batch_stats"]["mean"], atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), upd["batch_stats"]["var"], atol=1e-5)
    # torch's own train-mode batch norm keeps the unbiased variance: not flax's.
    tv = torch.from_numpy(var).clone()
    torch.nn.functional.batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2),
                                   torch.from_numpy(mean).clone(), tv, training=True,
                                   momentum=0.01, eps=1e-3)
    assert np.abs(tv.numpy() - upd["batch_stats"]["var"]).max() > 1e-4
    bn.eval()
    y = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    eval_bn = nn.BatchNorm(use_running_average=True, momentum=0.99, epsilon=1e-3)
    want_eval = eval_bn.apply(upd | {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(), np.asarray(want_eval),
                               atol=1e-5)


@pytest.mark.parametrize("total,warmup", [(10, 1), (1000, 50), (7, 3)])
def test_schedule_matches_optax(total, warmup):
    _, want = jts.make_optimizer(0.08, total, warmup)
    _, got = tts.make_optimizer(0.08, total, warmup)
    for count in sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2, total - 1, total,
                         total + 5}):
        w = float(want(jnp.asarray(count, jnp.int32)))
        assert abs(got(count) - w) <= 1e-6 * 0.08, (count, got(count), w)
    assert got(0) == 0.0


def _toy_params(rng):
    """Port-named parameters of a few kinds: conv kernels (decayed),
    depthwise kernels (decayed), BatchNorm scales and biases (not), under
    a trained and a frozen top key."""
    shapes = {"backbone.stem.weight": (8, 3, 3, 3), "backbone.stem_bn.bn.weight": (8,),
              "backbone.stem_bn.bn.bias": (8,), "box_net.conv0.depthwise.weight": (8, 1, 3, 3),
              "box_net.conv0.pointwise.weight": (4, 8, 1, 1), "box_net.conv0.pointwise.bias": (4,),
              "box_net.bn0_p3.weight": (4,), "box_net.bn0_p3.bias": (4,)}
    return {k: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)) for k, s in shapes.items()}


@pytest.mark.parametrize("norm,freeze", [(25.0, ()), (4.0, ()), (25.0, ("backbone",))])
def test_optimizer_update_matches_optax(norm, freeze):
    """Clip only at |g| >= 10 and to (g / |g|) * 10, decay by flax's mask,
    momentum trace, -lr(count) with the count before it increments."""
    rng = np.random.default_rng(int(norm))
    params = _toy_params(rng)
    grads = {k: torch.from_numpy(rng.normal(0, 1, v.shape).astype(np.float32))
             for k, v in params.items()}
    if freeze:
        grads = {k: (torch.zeros_like(g) if k.split(".")[0] in freeze else g)
                 for k, g in grads.items()}
    total = float(torch.linalg.vector_norm(torch.cat([g.flatten() for g in grads.values()])))
    grads = {k: g * (norm / total) for k, g in grads.items()}
    jtx, _ = jts.make_optimizer(LR, TOTAL, 2, freeze_top_keys=freeze)
    ttx, _ = tts.make_optimizer(LR, TOTAL, 2, freeze_top_keys=freeze)
    def params_tree(d):
        return to_flax_variables(d, ("params",))["params"]

    def to_jax(d):
        return jax.tree.map(jnp.asarray, params_tree(d))

    jp = to_jax(params)
    jstate, tstate = jtx.init(jp), ttx.init(params)
    tp = params
    for _ in range(3):  # counts 0 (lr 0), 1 (peak), 2
        jup, jstate = jtx.update(to_jax(grads), jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, jup)
        tup, tstate = ttx.update(grads, tstate, tp)
        tp = tts.apply_updates(tp, tup)
        for (path, want), (_, got) in zip(_leaves(jp), _leaves(params_tree(tp))):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=str(path))
    for k in params:
        if k.split(".")[0] in freeze:
            torch.testing.assert_close(tp[k], params[k], rtol=0, atol=0)
    assert tstate.count == 3


def _batch(rng, b=2, size=64):
    images = rng.uniform(-1, 1, size=(b, size, size, 3)).astype(np.float32)
    boxes = np.array([[[10, 12, 40, 44], [30, 5, 60, 30], [0, 0, 0, 0]],
                      [[5, 20, 30, 58], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
    valid = np.array([[True, True, False], [True, False, False]])
    return images, boxes, valid


def _three_steps(freeze):
    """Three steps on each side from JAX's initial state; returns (freeze,
    [(JAX tree, port tree, JAX metrics, port metrics) after each step], the
    initial and the final port state)."""
    jtrainer = jts.Trainer(JaxModelSpec(*TINY), base_lr=LR, total_steps=TOTAL,
                           warmup_steps=WARMUP, dtype=jnp.float64, freeze_top_keys=freeze)
    jstate = jtrainer.init_state(seed=0)
    assert jax.tree.leaves(jstate.params)[0].dtype == jnp.float64
    ttrainer = tts.Trainer(ModelSpec(*TINY), base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP,
                           freeze_top_keys=freeze, device="cpu", dtype=torch.float64)
    tree = jax.tree.map(np.asarray, flax.serialization.to_state_dict(jstate))
    tstate = train_state_from_flax(tree, ttrainer.init_state(seed=0))
    start = tstate
    images, boxes, valid = _batch(np.random.default_rng(0))
    jbatch = {"images": jnp.asarray(images), "gt_boxes": jnp.asarray(boxes),
              "gt_valid": jnp.asarray(valid)}
    tbatch = {"images": torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(),
              "gt_boxes": torch.from_numpy(boxes), "gt_valid": torch.from_numpy(valid)}
    out = []
    for _ in range(STEPS):
        jstate, jm = jtrainer.train_step(jstate, jbatch)
        tstate, tm = ttrainer.train_step(tstate, tbatch)
        out.append((jax.tree.map(np.asarray, flax.serialization.to_state_dict(jstate)),
                    train_state_to_flax(tstate), jm, tm))
    evals = (jtrainer.eval_loss(jstate, jbatch), ttrainer.eval_loss(tstate, tbatch))
    return freeze, out, start, tstate, evals


@pytest.fixture(scope="module")
def whole():
    return _three_steps(())


@pytest.fixture(scope="module")
def heads_only():
    return _three_steps(FREEZE)


@pytest.mark.parametrize("mode", ["whole", "heads_only"])
def test_three_steps_match_jax(mode, request):
    freeze, out, _, _, (jeval, teval) = request.getfixturevalue(mode)
    assert jeval.keys() == teval.keys()
    for k in jeval:  # the validation loss after the steps, running statistics
        assert abs(float(teval[k]) - float(jeval[k])) <= 1e-4 * abs(float(jeval[k])), k
    for step, (jtree, ttree, jm, tm) in enumerate(out):
        for k in ("loss", "cls_loss", "box_loss", "num_pos"):
            w = float(jm[k])
            assert abs(float(tm[k]) - w) <= 1e-4 * abs(w), (step, k, float(tm[k]), w)
        assert abs(tm["lr"] - float(jm["lr"])) <= 1e-6 * float(jm["lr"]), step
        assert int(ttree["step"]) == int(jtree["step"]) == step + 1
        got = dict(_leaves(ttree))
        want = dict(_leaves(jtree))
        assert got.keys() == want.keys()
        for path, w in want.items():
            g = got[path]
            assert g.shape == w.shape and g.dtype.kind == w.dtype.kind, path
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 + 1e-4 * np.abs(w).max(),
                                           err_msg=f"step {step + 1} {'/'.join(path)}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=str(path))
    # The trace moved in the first step (lr(0) = 0 moves no parameter).
    assert any(np.abs(v).max() > 0 for p, v in _leaves(out[0][1]["opt_state"]))


def test_heads_only_keeps_frozen_subtrees_bit_for_bit(heads_only):
    freeze, _, start, end, _ = heads_only
    moved = 0
    for k, v in start.params.items():
        if k.split(".")[0] in freeze:
            assert torch.equal(end.params[k], v), k
            assert not end.opt_state.trace[k].any(), k
        else:
            moved += not torch.equal(end.params[k], v)
    for k, v in start.batch_stats.items():
        if k.split(".")[0] in freeze:
            assert torch.equal(end.batch_stats[k], v), k
    assert moved > 0
    assert any(not torch.equal(end.batch_stats[k], v) for k, v in start.batch_stats.items())


def test_init_follows_flax_initializers():
    """init_parameters draws another stream than JAX's, from flax's
    distributions: the same tree and shapes as JAX's init; every conv
    kernel a normal cut at two of its stddevs with stddev sqrt(1 / fan_in)
    (lecun_normal; the sample stddev within 10% where a kernel has at
    least 1000 entries), biases 0 but the class head's prior
    -log(99), BatchNorm scale 1 and bias 0, running mean 0 and variance 1."""
    jstate = jts.Trainer(JaxModelSpec(*TINY), total_steps=10, warmup_steps=1).init_state(seed=0)
    trainer = tts.Trainer(ModelSpec(*TINY), total_steps=10, warmup_steps=1, device="cpu")
    state = trainer.init_state(seed=0)
    got = to_flax_variables(trainer.variables(state))
    want = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    shapes = lambda t: {p: v.shape for p, v in _leaves(t)}  # noqa: E731
    assert shapes(got) == shapes(jax.tree.map(np.asarray, want))
    prior = -np.log(99.0)
    for path, v in _leaves(got["params"]):
        if path[-1] == "kernel":
            std = np.sqrt(1.0 / np.prod(v.shape[:3]))  # HWIO: fan_in = kh * kw * in
            assert np.abs(v).max() <= 2 * std / 0.87962566103423978 * (1 + 1e-6), path
            if v.size >= 1000:
                assert abs(v.std() / std - 1) < 0.1 and abs(v.mean()) < 0.1 * std, path
        elif path[-1] == "scale":
            assert (v == 1).all(), path
        elif path[:3] == ("class_net", "final", "pointwise"):
            np.testing.assert_allclose(v, prior, rtol=1e-6)
        else:
            assert (v == 0).all(), path
    for path, v in _leaves(got["batch_stats"]):
        assert (v == (1 if path[-1] == "var" else 0)).all(), path
    again = trainer.init_state(seed=0)
    assert all(torch.equal(again.params[k], p) for k, p in state.params.items())
