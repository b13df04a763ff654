"""bfloat16 training: the port's ``Trainer(dtype=torch.bfloat16)`` against the
JAX package's ``Trainer(dtype=jnp.bfloat16)`` (flax's compute dtype), on
the CPU.

Both sides start from JAX's initialised state converted into the port and
take one step on one batch at a small size (lite0 widths cut to 32
channels, one BiFPN and head repeat, 64 px, B = 2), in bfloat16 and in
float32. Held:

- the first bfloat16 loss (and its parts) within 3e-2 relative of JAX's.
  Two bfloat16 forwards round at other points (the convolution's bias
  added before or after its bfloat16 rounding, sums in the CPU library's
  own order), each about 2^-9 relative a layer, and through the model that
  moves this loss by 1-2%, as much as bfloat16 against float32 does
  (measured 1.0e-2 here);
- the port's own bfloat16-against-float32 loss gap within twice JAX's own
  gap plus 1e-2: computing in bfloat16 costs the port what it costs JAX
  (measured 1.3e-2 against JAX's 2.3e-2), and the gap is not 0, so the
  step did compute in bfloat16;
- every leaf of params, EMA, batch statistics and the momentum trace
  float32 after the step, and the lr(0) = 0 step moved no parameter.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import flax.serialization  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vbt_tpu.models import ModelSpec as JaxModelSpec  # noqa: E402
from vbt_tpu.train import train_step as jts  # noqa: E402
from vbt_tpu_torch.models import ModelSpec  # noqa: E402
from vbt_tpu_torch.runtime.checkpoint import train_state_from_flax  # noqa: E402
from vbt_tpu_torch.train import train_step as tts  # noqa: E402

TINY = ("tiny", "lite0", 64, 32, 1, 1)
LR, TOTAL, WARMUP = 0.05, 10, 1
LOSS_RTOL = 3e-2
GAP_FLOOR = 1e-2
METRICS = ("loss", "cls_loss", "box_loss")


def _batch():
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, size=(2, 64, 64, 3)).astype(np.float32)
    boxes = np.array([[[10, 12, 40, 44], [30, 5, 60, 30], [0, 0, 0, 0]],
                      [[5, 20, 30, 58], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
    valid = np.array([[True, True, False], [True, False, False]])
    jax_batch = {"images": jnp.asarray(images), "gt_boxes": jnp.asarray(boxes),
                 "gt_valid": jnp.asarray(valid)}
    port_batch = {"images": torch.from_numpy(images).permute(0, 3, 1, 2).contiguous(),
                  "gt_boxes": torch.from_numpy(boxes), "gt_valid": torch.from_numpy(valid)}
    return jax_batch, port_batch


@pytest.fixture(scope="module")
def steps():
    """{dtype name: (JAX metrics, port metrics, port start, port state)}, one
    step from JAX's initial state on each side."""
    jax_batch, port_batch = _batch()
    out = {}
    for name, jdtype, tdtype in (("float32", jnp.float32, torch.float32),
                                 ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        jtrainer = jts.Trainer(JaxModelSpec(*TINY), base_lr=LR, total_steps=TOTAL,
                               warmup_steps=WARMUP, dtype=jdtype)
        jstate = jtrainer.init_state(seed=0)
        ttrainer = tts.Trainer(ModelSpec(*TINY), base_lr=LR, total_steps=TOTAL,
                               warmup_steps=WARMUP, device="cpu", dtype=tdtype)
        tree = jax.tree.map(np.asarray, flax.serialization.to_state_dict(jstate))
        start = train_state_from_flax(tree, ttrainer.init_state(seed=0))
        _, jm = jtrainer.train_step(jstate, jax_batch)
        tstate, tm = ttrainer.train_step(start, port_batch)
        out[name] = ({k: float(jm[k]) for k in METRICS}, {k: float(tm[k]) for k in METRICS},
                     start, tstate)
    return out


def test_bf16_step_matches_jax(steps):
    jm, tm, _, _ = steps["bfloat16"]
    for k in METRICS:
        assert abs(tm[k] - jm[k]) <= LOSS_RTOL * abs(jm[k]), (k, tm[k], jm[k])


def test_bf16_costs_the_port_what_it_costs_jax(steps):
    (j16, t16, _, _), (j32, t32, _, _) = steps["bfloat16"], steps["float32"]
    jax_gap = abs(j16["loss"] - j32["loss"]) / abs(j32["loss"])
    port_gap = abs(t16["loss"] - t32["loss"]) / abs(t32["loss"])
    assert 0 < port_gap <= 2 * jax_gap + GAP_FLOOR, (port_gap, jax_gap)


def test_bf16_state_stays_float32(steps):
    _, _, start, state = steps["bfloat16"]
    groups = {"params": state.params, "ema_params": state.ema_params,
              "batch_stats": state.batch_stats, "trace": state.opt_state.trace}
    for group, leaves in groups.items():
        assert {v.dtype for v in leaves.values()} == {torch.float32}, group
    assert all(torch.equal(state.params[k], v) for k, v in start.params.items())  # lr(0) = 0
    assert any(state.opt_state.trace[k].abs().max() > 0 for k in state.params)
    assert any(not torch.equal(state.batch_stats[k], v) for k, v in start.batch_stats.items())
