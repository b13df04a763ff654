"""Checkpoints stay loadable by both packages.

The port's msgpack writer re-encodes every shipped checkpoint to the file's
own bytes; a train checkpoint the port writes loads with the JAX package's
``load_train_checkpoint`` into a JAX ``TrainState`` (and JAX writes the
same bytes again), and one JAX writes loads into the port, with and
without frozen keys (whose masked optimizer state shifts optax's chain);
an exported model loads with the JAX ``load_params``. Every comparison is
exact: values bit for bit, dtypes equal, the layout of flax's state dict.
"""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import flax.serialization  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vbt_tpu.models import ModelSpec as JaxModelSpec  # noqa: E402
from vbt_tpu.runtime import checkpoint as jck  # noqa: E402
from vbt_tpu.train.train_step import Trainer as JaxTrainer  # noqa: E402
from vbt_tpu_torch.models import ModelSpec  # noqa: E402
from vbt_tpu_torch.runtime import checkpoint as tck  # noqa: E402
from vbt_tpu_torch.train.train_step import Trainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = sorted(glob.glob(os.path.join(REPO, "models", "*.msgpack")))
TINY = ("tiny", "lite0", 64, 32, 1, 1)
FREEZE = ("backbone", "fpn")


@pytest.mark.parametrize("path", SHIPPED, ids=os.path.basename)
def test_shipped_checkpoint_reencodes_to_its_bytes(path):
    with open(path, "rb") as f:
        raw = f.read()
    tree = tck.msgpack_restore(raw)
    assert tck.msgpack_pack(tree) == raw
    # Through the port's state_dict (OIHW, 'bn') and back: the bytes, with
    # the collections in the order the file has them (JAX's save_params
    # writes params first; one shipped file has them sorted).
    order = tuple(tree)
    assert tck.msgpack_pack(tck.to_flax_variables(tck.load_checkpoint(path), order)) == raw
    if order == ("params", "batch_stats"):
        assert tck.msgpack_pack(tck.to_flax_variables(tck.load_checkpoint(path))) == raw


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=str(k))


def _perturbed(state, gen):
    """A port state with every float leaf random and the counters moved,
    so a round trip shows which leaf went where."""
    rnd = lambda d: {k: torch.randn(v.shape, generator=gen) for k, v in d.items()}  # noqa: E731
    opt = state.opt_state._replace(trace=rnd(state.opt_state.trace), count=7)
    return state._replace(step=7, params=rnd(state.params), batch_stats=rnd(state.batch_stats),
                          opt_state=opt, ema_params=rnd(state.ema_params))


def _jax_template(freeze):
    trainer = JaxTrainer(JaxModelSpec(*TINY), total_steps=10, warmup_steps=1,
                         freeze_top_keys=freeze)
    state = trainer.init_state(seed=0)
    return jax.tree.map(  # the float32 state JAX trains (x64 made some leaves float64)
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x, state)


@pytest.mark.parametrize("freeze", [(), FREEZE], ids=["whole", "heads_only"])
def test_port_train_checkpoint_loads_in_jax(freeze, tmp_path):
    trainer = Trainer(ModelSpec(*TINY), total_steps=10, warmup_steps=1, freeze_top_keys=freeze,
                      device="cpu")
    state = _perturbed(trainer.init_state(seed=0), torch.Generator().manual_seed(1))
    tck.save_train_checkpoint(str(tmp_path), 7, state)
    assert jck.latest_train_checkpoint(str(tmp_path)) == 7
    loaded = jck.load_train_checkpoint(str(tmp_path), 7, _jax_template(freeze))
    _assert_trees_equal(flax.serialization.to_state_dict(loaded), tck.train_state_to_flax(state))
    assert np.asarray(loaded.step).dtype == np.int32 and int(loaded.step) == 7
    with open(tmp_path / "step_00000007.msgpack", "rb") as f:
        assert flax.serialization.to_bytes(loaded) == f.read()  # the bytes JAX writes
    # And back into the port, bit for bit.
    again = tck.load_train_checkpoint(str(tmp_path), 7, trainer.init_state(seed=0))
    assert again.step == 7 and again.opt_state.count == 7 and again.opt_state.frozen == freeze
    for a, b in ((again.params, state.params), (again.batch_stats, state.batch_stats),
                 (again.opt_state.trace, state.opt_state.trace),
                 (again.ema_params, state.ema_params)):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("freeze", [(), FREEZE], ids=["whole", "heads_only"])
def test_jax_train_checkpoint_loads_in_port(freeze, tmp_path):
    jstate = _jax_template(freeze)
    leaves, treedef = jax.tree.flatten(jstate)
    rng = np.random.default_rng(2)
    leaves = [np.asarray(rng.normal(size=np.shape(x)), np.float32)
              if jnp.issubdtype(x.dtype, jnp.floating) else x for x in leaves]
    jstate = jax.tree.unflatten(treedef, leaves)._replace(step=jnp.asarray(5, jnp.int32))
    jck.save_train_checkpoint(str(tmp_path), 5, jstate)
    trainer = Trainer(ModelSpec(*TINY), total_steps=10, warmup_steps=1, freeze_top_keys=freeze,
                      device="cpu")
    assert tck.latest_train_checkpoint(str(tmp_path)) == 5
    state = tck.load_train_checkpoint(str(tmp_path), 5, trainer.init_state(seed=0))
    _assert_trees_equal(tck.train_state_to_flax(state), flax.serialization.to_state_dict(jstate))
    other = Trainer(ModelSpec(*TINY), total_steps=10, warmup_steps=1,
                    freeze_top_keys=() if freeze else FREEZE, device="cpu")
    with pytest.raises(KeyError, match="optimizer state layout"):
        tck.load_train_checkpoint(str(tmp_path), 5, other.init_state(seed=0))


def test_exported_params_load_in_jax(tmp_path):
    trainer = Trainer(ModelSpec(*TINY), total_steps=10, warmup_steps=1, device="cpu")
    state = _perturbed(trainer.init_state(seed=0), torch.Generator().manual_seed(3))
    path = str(tmp_path / "tiny_whole.msgpack")
    tck.save_params(path, trainer.variables(state, use_ema=True))
    jstate = _jax_template(())
    loaded = jck.load_params(path, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    _assert_trees_equal(loaded, tck.to_flax_variables(trainer.variables(state, use_ema=True)))
    back = tck.load_params(path, trainer.variables(state))
    assert all(torch.equal(back[k], v) for k, v in trainer.variables(state, use_ema=True).items())
    with pytest.raises(KeyError):
        tck.load_params(path, {"backbone.stem.weight": state.params["backbone.stem.weight"]})
