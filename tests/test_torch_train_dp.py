"""The port's data-parallel train step against the JAX package's, on the CPU.

JAX's side is its real sharded step: ``Trainer(..., mesh=make_mesh(n))``
over the first n of the test configuration's 8 virtual CPU devices, the
batch ``device_put`` under ``PartitionSpec("data", ...)`` and the state
replicated, as ``__graft_entry__.py:188-197`` runs it. The port's side is
``Trainer(mesh=[cpu] * n)``: a share of the global batch a thread, the
BatchNorm statistics summed across the shares. Both start from the
port's seed-0 initial state, converted into JAX's ``TrainState`` (its
optimizer state from its own chain), and take three steps on one global
batch of n images, one a device as in ``__graft_entry__.py``'s dry run,
in float64, whole model and heads-only. Held:

- against JAX's sharded step, n = 2 and 4: the losses within 1e-4
  relative, every leaf of params, batch_stats, trace and EMA within
  ``1e-5 + 1e-4 * max|JAX leaf|`` (``test_torch_train_step.py``'s bounds),
  the validation loss after the steps (``eval_loss``, whole model: JAX's
  evaluation does not depend on the freeze) within 1e-4 relative; frozen
  leaves bit for bit their start;
- against the port's one-device step on the same global batch, which does
  the same arithmetic with the batch sums in another order: the losses and
  the running statistics within 1e-9 relative, the trace within 1e-7 of
  its largest value, params and EMA within 1e-12 plus the learning rate
  times that (``chip_smoke.py``'s ``TRAIN_BOUNDS["float64"]``); the
  sharded ``eval_forward`` within 1e-12 and ``eval_loss`` within 1e-9;
- every share writes the same running statistics, bit for bit;
- a mesh of one device is the one-device step bit for bit;
- a global batch that does not split is refused; a failing share raises
  from ``train_step`` at once, and the next step runs; a share left alone
  at a BatchNorm stops when its wait for the turn times out; the shares
  take turns in mesh order under a microsecond switch interval;
- bfloat16 over two devices against the one-device bfloat16 step: the
  losses within 3e-2 relative (``test_torch_train_bf16.py``'s bound), the
  state float32;
- ``Trainer.init_state(input_size=)`` is accepted and moves no shape, as
  in flax.
"""

import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import flax.serialization  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

from vbt_tpu.models import ModelSpec as JaxModelSpec  # noqa: E402
from vbt_tpu.parallel.mesh import make_mesh, replicated  # noqa: E402
from vbt_tpu.train import train_step as jts  # noqa: E402
from vbt_tpu_torch import entry  # noqa: E402
from vbt_tpu_torch.models import ModelSpec  # noqa: E402
from vbt_tpu_torch.parallel import data_parallel  # noqa: E402
from vbt_tpu_torch.runtime.checkpoint import train_state_to_flax  # noqa: E402
from vbt_tpu_torch.train import train_step as tts  # noqa: E402

TINY = ("tiny", "lite0", 64, 32, 1, 1)
FREEZE = ("backbone", "fpn")
STEPS = 3
LR, TOTAL, WARMUP = 0.05, 10, 1
CPU = torch.device("cpu")
# The port's data-parallel step against its one-device step, float64:
# (losses and running statistics relative, trace relative to its largest
# value, absolute floor), chip_smoke.py's TRAIN_BOUNDS["float64"].
TIGHT = (1e-9, 1e-7, 1e-12)
EVAL_TIGHT = 1e-12
BF16_LOSS_RTOL = 3e-2
CONFIGS = [(2, ()), (4, ()), (2, FREEZE), (4, FREEZE)]
IDS = ["n2-whole", "n4-whole", "n2-heads_only", "n4-heads_only"]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _batch(b):
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, size=(b, 64, 64, 3)).astype(np.float32)
    boxes = np.zeros((b, 3, 4), np.float32)
    valid = np.zeros((b, 3), bool)
    for i in range(b):
        for g in range(1 + i % 2):
            x0, y0 = rng.uniform(0, 34, 2)
            w, h = rng.uniform(12, 30, 2)
            boxes[i, g] = [x0, y0, min(x0 + w, 64), min(y0 + h, 64)]
            valid[i, g] = True
    return images, boxes, valid


def _port_batch(images, boxes, valid):
    return {"images": torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(),
            "gt_boxes": torch.from_numpy(boxes), "gt_valid": torch.from_numpy(valid)}


def _trainer(freeze=(), mesh=None, dtype=torch.float64, **kw):
    return tts.Trainer(ModelSpec(*TINY), base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP,
                       freeze_top_keys=freeze, dtype=dtype, mesh=mesh,
                       device=None if mesh else "cpu", **kw)


def _start(freeze):
    """The port's seed-0 initial state and the same values as JAX's
    ``TrainState`` (its optax state from JAX's own chain); the running
    statistics float64, the dtype JAX's float64 step gives them, so its
    step is compiled once."""
    start = _trainer(freeze).init_state(seed=0)
    tree = jax.tree.map(jnp.asarray, train_state_to_flax(start))
    return start, jts.TrainState(step=tree["step"], params=tree["params"],
                                 batch_stats=tree["batch_stats"],
                                 opt_state=_jax_trainer(freeze).tx.init(tree["params"]),
                                 ema_params=tree["ema_params"])


def _jax_trainer(freeze, n=None):
    return jts.Trainer(JaxModelSpec(*TINY), base_lr=LR, total_steps=TOTAL, warmup_steps=WARMUP,
                       dtype=jnp.float64, freeze_top_keys=freeze,
                       mesh=None if n is None else make_mesh(n))


def _jax_sharded(n, freeze, jstate):
    """JAX's sharded run from ``jstate``: after each step (flax state dict,
    metrics), and the validation metrics after the steps (the whole model
    only: JAX's evaluation does not depend on the freeze)."""
    jtrainer = _jax_trainer(freeze, n)
    mesh = jtrainer.mesh
    images, boxes, valid = _batch(n)
    with mesh:
        batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(
                     mesh, PartitionSpec("data", *([None] * (v.ndim - 1)))))
                 for k, v in (("images", images), ("gt_boxes", boxes), ("gt_valid", valid))}
        state = jax.device_put(jstate, replicated(mesh))
        steps = []
        for _ in range(STEPS):
            state, m = jtrainer.train_step(state, batch)
            steps.append((jax.tree.map(np.asarray, flax.serialization.to_state_dict(state)),
                          {k: float(v) for k, v in m.items()}))
        assert len(state.step.sharding.device_set) == n
        evals = None if freeze else {k: float(v)
                                     for k, v in jtrainer.eval_loss(state, batch).items()}
    return steps, evals


def _port_steps(trainer, start, batch):
    """The port's steps from ``start``: [(state, metrics)] after each."""
    state, out = start, []
    for _ in range(STEPS):
        state, m = trainer.train_step(state, batch)
        out.append((state, m))
    return out


@pytest.fixture(scope="module")
def runs():
    """{(n, freeze): JAX's sharded run, the port's data-parallel trainer,
    start, steps, one-device trainer and steps, and the batch}: one JAX
    compile of the step a configuration."""
    out = {}
    for freeze in ((), FREEZE):
        start, jstate = _start(freeze)
        for n in (2, 4):
            batch = _port_batch(*_batch(n))
            trainer, one = _trainer(freeze, mesh=[CPU] * n), _trainer(freeze)
            out[n, freeze] = (_jax_sharded(n, freeze, jstate), trainer, start,
                              _port_steps(trainer, start, batch), one,
                              _port_steps(one, start, batch), batch)
    return out


@pytest.mark.parametrize("n,freeze", CONFIGS, ids=IDS)
def test_dp_steps_match_jax_sharded_step(runs, n, freeze):
    (jax_steps, jax_evals), trainer, start, steps, _, _, batch = runs[n, freeze]
    assert len(trainer.share_models) == n
    for step, ((jtree, jm), (state, tm)) in enumerate(zip(jax_steps, steps)):
        for k in ("loss", "cls_loss", "box_loss", "num_pos"):
            assert abs(float(tm[k]) - jm[k]) <= 1e-4 * abs(jm[k]), (step, k, float(tm[k]), jm[k])
        assert abs(tm["lr"] - jm["lr"]) <= 1e-6 * jm["lr"], step
        ttree = train_state_to_flax(state)
        got, want = dict(_leaves(ttree)), dict(_leaves(jtree))
        assert got.keys() == want.keys()
        for path, w in want.items():
            g = got[path]
            assert g.shape == w.shape and g.dtype.kind == w.dtype.kind, path
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 + 1e-4 * np.abs(w).max(),
                                           err_msg=f"step {step + 1} {'/'.join(path)}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=str(path))
    end = steps[-1][0]
    if jax_evals is not None:
        evals = trainer.eval_loss(end, batch)
        for k, w in jax_evals.items():
            assert abs(float(evals[k]) - w) <= 1e-4 * abs(w), k
    moved = 0
    for group in ("params", "batch_stats"):
        for k, v in getattr(start, group).items():
            if trainer.is_frozen(k):
                assert torch.equal(getattr(end, group)[k], v), k
            else:
                moved += not torch.equal(getattr(end, group)[k], v)
    assert moved > 0
    assert all(not end.opt_state.trace[k].any() for k in end.params if trainer.is_frozen(k))


def _tight_ratios(got, want):
    """Each group's largest difference over its ``TIGHT`` bound; 1 is the bound."""
    rtol, trace_rtol, atol = TIGHT
    trace_max = max(float(t.abs().max()) for t in want.opt_state.trace.values())

    def worst(group, bound):
        g, w = getattr(got, group), getattr(want, group)
        if group == "opt_state":
            g, w = g.trace, w.trace
        return max(float((g[k] - v).abs().max()) / bound(v) for k, v in w.items())

    moved = lambda v: atol + LR * trace_rtol * trace_max  # noqa: E731
    return {"params": worst("params", moved), "ema_params": worst("ema_params", moved),
            "batch_stats": worst("batch_stats", lambda v: atol + rtol * float(v.abs().max())),
            "trace": worst("opt_state", lambda v: atol + trace_rtol * trace_max)}


@pytest.mark.parametrize("n,freeze", CONFIGS, ids=IDS)
def test_dp_step_matches_one_device_step(runs, n, freeze):
    _, trainer, _, steps, one, one_steps, batch = runs[n, freeze]
    for step, ((state, m), (want, wm)) in enumerate(zip(steps, one_steps)):
        for k in ("loss", "cls_loss", "box_loss", "num_pos"):
            assert abs(float(m[k]) - float(wm[k])) <= TIGHT[0] * abs(float(wm[k])), (step, k)
        ratios = _tight_ratios(state, want)
        assert max(ratios.values()) <= 1, (step + 1, ratios)
    end = steps[-1][0]
    for got, want in zip(trainer.eval_forward(end, batch["images"]),
                         one.eval_forward(end, batch["images"])):
        torch.testing.assert_close(got, want, rtol=0, atol=EVAL_TIGHT)
    got, want = trainer.eval_loss(end, batch), one.eval_loss(end, batch)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= TIGHT[0] * abs(float(want[k])), k


def test_every_share_writes_the_same_statistics(runs, monkeypatch):
    """The shares' running statistics after one step, captured from the
    tensors each share's forward was given (updated there in place)."""
    _, trainer, start, _, _, _, batch = runs[4, ()]
    given = {}
    real = tts.functional_call

    def record(model, tensors, args):
        given[trainer.share_models.index(model)] = tensors
        return real(model, tensors, args)

    monkeypatch.setattr(tts, "functional_call", record)
    state, _ = trainer.train_step(start, batch)
    assert sorted(given) == [0, 1, 2, 3]
    for k, v in state.batch_stats.items():
        assert given[0][k] is v, k  # the first share's are the state's
        for share in (1, 2, 3):
            assert given[share][k] is not v and torch.equal(given[share][k], v), (share, k)
    assert all(not torch.equal(state.batch_stats[k], v) for k, v in start.batch_stats.items())


def test_one_device_mesh_is_the_one_device_step():
    batch = _port_batch(*_batch(2))
    one, meshed = _trainer(), _trainer(mesh=[CPU])
    assert len(meshed.share_models) == 1 and meshed.device == CPU
    a = b = one.init_state(seed=0)
    for _ in range(2):
        a, am = one.train_step(a, batch)
        b, bm = meshed.train_step(b, batch)
        assert all(torch.equal(am[k], bm[k]) for k in am if k != "lr")
        for group in ("params", "batch_stats", "ema_params"):
            assert all(torch.equal(getattr(a, group)[k], v)
                       for k, v in getattr(b, group).items()), group
        assert all(torch.equal(a.opt_state.trace[k], v) for k, v in b.opt_state.trace.items())
    for x, y in zip(one.eval_forward(a, batch["images"]), meshed.eval_forward(b, batch["images"])):
        assert torch.equal(x, y)


def test_uneven_global_batch_is_refused():
    trainer = _trainer(mesh=[CPU] * 2)
    state = trainer.init_state(seed=0)
    batch = _port_batch(*_batch(3))
    with pytest.raises(ValueError, match="3 clips do not split evenly over 2 devices"):
        trainer.train_step(state, batch)
    with pytest.raises(ValueError, match="3 clips do not split evenly over 2 devices"):
        trainer.eval_forward(state, batch["images"])


def test_a_failing_share_raises_at_once_and_the_next_step_runs():
    trainer = _trainer(mesh=[CPU] * 2)
    state = trainer.init_state(seed=0)
    batch = _port_batch(*_batch(2))
    heads = trainer.share_models[1].class_net

    def fail(*args, **kw):
        raise RuntimeError("share 1 failed")

    heads.forward = fail  # share 0 waits at the class head's first BatchNorm
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="share 1 failed") as err:
        trainer.train_step(state, batch)
    assert time.perf_counter() - t0 < data_parallel.TURN_TIMEOUT_S / 10
    assert any("share 1 of 2" in note for note in err.value.__notes__)
    del heads.forward
    new, metrics = trainer.train_step(state, batch)
    assert new.step == 1 and np.isfinite(float(metrics["loss"]))


def test_a_share_left_alone_stops_at_the_timeout():
    """Share 0 at a BatchNorm hands the turn to share 1, which never runs."""
    turns = data_parallel.Turns(2, timeout=0.5)
    stats = data_parallel.GlobalBatchStats([CPU] * 2, turns)
    turns.wait(0)
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="share 0 waited"):
        stats.stats(0, torch.ones(2, 3, 4, 4))
    assert 0.4 < time.perf_counter() - t0 < 30


def test_global_stats_under_thread_switches():
    """More shares than cores, a switch interval of a microsecond, many
    BatchNorm calls: the shares run one at a time in mesh order, and every
    share gets the statistics of the concatenated batch, folded in mesh
    order, at every call."""
    n, calls, channels = 12, 40, 5
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.normal(size=(calls, n, 2, channels, 3, 3)))
    turns = data_parallel.Turns(n, timeout=60)
    stats = data_parallel.GlobalBatchStats([CPU] * n, turns)
    got = [[None] * calls for _ in range(n)]
    order = []

    def share(i):
        for c in range(calls):
            order.append((c, i))
            got[i][c] = stats.stats(i, xs[c, i])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        data_parallel.ShareThreads([CPU] * n).run(share, turns)
    finally:
        sys.setswitchinterval(interval)
    assert order == [(c, i) for c in range(calls) for i in range(n)]  # one at a time
    count = n * 2 * 3 * 3
    for c in range(calls):
        s1 = s2 = 0
        for i in range(n):
            s1 = s1 + xs[c, i].sum(dim=(0, 2, 3))
            s2 = s2 + (xs[c, i] * xs[c, i]).sum(dim=(0, 2, 3))
        mean = s1 / count
        var = torch.clamp(s2 / count - mean * mean, min=0.0)
        for i in range(n):
            assert torch.equal(got[i][c][0], mean) and torch.equal(got[i][c][1], var), (c, i)
        whole = xs[c].reshape(n * 2, channels, 3, 3)
        torch.testing.assert_close(mean, whole.mean(dim=(0, 2, 3)), rtol=1e-12, atol=1e-12)


def test_bf16_dp_step_matches_one_device_bf16_step():
    batch = _port_batch(*_batch(2))
    one, dp = _trainer(dtype=torch.bfloat16), _trainer(mesh=[CPU] * 2, dtype=torch.bfloat16)
    a = b = one.init_state(seed=0)
    for _ in range(2):
        a, am = one.train_step(a, batch)
        b, bm = dp.train_step(b, batch)
        for k in ("loss", "cls_loss", "box_loss"):
            assert abs(float(bm[k]) - float(am[k])) <= BF16_LOSS_RTOL * abs(float(am[k])), k
    groups = (b.params, b.ema_params, b.batch_stats, b.opt_state.trace)
    assert {v.dtype for g in groups for v in g.values()} == {torch.float32}


def test_dryrun_trains_data_parallel(monkeypatch):
    """``entry.dryrun_multichip`` over two CPU devices runs its train step
    through the global statistics, the same number of BatchNorms a share."""
    calls = {}
    real = data_parallel.GlobalBatchStats.stats

    def count(self, share, x):
        calls[share] = calls.get(share, 0) + 1
        return real(self, share, x)

    monkeypatch.setattr(data_parallel.GlobalBatchStats, "stats", count)
    entry.dryrun_multichip(2, devices=[CPU] * 2)
    assert sorted(calls) == [0, 1] and calls[0] == calls[1] > 0


def test_init_state_takes_input_size_as_flax_does():
    """JAX's ``init_state(seed, input_size)`` traces its init at that size;
    no parameter's shape depends on it, in flax nor in the port (JAX's
    shapes by ``jax.eval_shape``, which compiles nothing)."""
    jtrainer = jts.Trainer(JaxModelSpec(*TINY), total_steps=TOTAL, warmup_steps=WARMUP)
    def shapes(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            out.update(shapes(v, prefix + (k,)) if isinstance(v, dict)
                       else {prefix + (k,): tuple(v.shape)})
        return out

    jshapes = [shapes(flax.serialization.to_state_dict(jax.eval_shape(
        lambda s=size: jtrainer.init_state(seed=0, input_size=s)))) for size in (None, 96)]
    assert jshapes[0] == jshapes[1]
    trainer = _trainer(dtype=torch.float32)
    want = trainer.init_state(seed=0)
    got = trainer.init_state(seed=0, input_size=96)
    assert shapes(train_state_to_flax(got)) == shapes(train_state_to_flax(want)) == jshapes[0]
    assert all(torch.equal(got.params[k], v) for k, v in want.params.items())
