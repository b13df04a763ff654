"""The port's entry points (``vbt_tpu_torch/entry.py``) and
``DetectionPipeline.init_variables`` against the JAX package on the CPU.

- JAX's ``__graft_entry__.entry()`` step and the port's ``entry()`` step,
  given the same variables (JAX's random initialization, converted with
  ``convert_flax_variables``) and the same frames (seeded uint8 at (2, 720,
  1280, 3)), give equal Detections: counts exact, scores and boxes within
  1e-4 (float32 on both sides: two forwards of the same weights, whose sums
  run in another order);
- ``init_variables`` has the keys and shapes of
  ``convert_flax_variables(JAX's init_variables(spec))``, every tensor
  float32 (JAX's dtype without the tests' x64); two
  seeds differ, one seed repeats, ``dtype`` casts every tensor;
- ``python -m vbt_tpu_torch.entry --device cpu`` (``main``) prints ``entry
  ok`` and ``dryrun ok``, with ``dryrun_multichip(2, devices=[cpu, cpu])``;
  a relay that moves a box is refused.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as jax_entry  # noqa: E402
from vbt_tpu_torch import entry  # noqa: E402
from vbt_tpu_torch.models import get_model_spec  # noqa: E402
from vbt_tpu_torch.runtime.checkpoint import convert_flax_variables, load_into  # noqa: E402
from vbt_tpu_torch.runtime.pipeline import DetectionPipeline  # noqa: E402

TOL = 1e-4


@pytest.fixture(scope="module")
def jax_step():
    """JAX's entry step, its variables and the frames."""
    fn, (variables, frames) = jax_entry.entry()
    assert frames.shape == (4, 720, 1280, 3) and frames.dtype == jnp.uint8
    frames = np.random.default_rng(0).integers(0, 256, size=(2, 720, 1280, 3), dtype=np.uint8)
    return jax.jit(fn), variables, frames


def test_entry_equals_jax(jax_step):
    jfn, variables, frames = jax_step
    want = jfn(variables, jnp.asarray(frames))
    fn, (model, zeros) = entry.entry(device="cpu")
    assert zeros.shape == (4, 720, 1280, 3) and zeros.dtype == torch.uint8
    assert int(fn(model, zeros).count.min()) >= 0
    load_into(model, convert_flax_variables(jax.tree.map(np.asarray, variables)))
    got = fn(model, torch.from_numpy(frames))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores, np.float32),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes, np.float32),
                               atol=TOL, rtol=0)


def test_init_variables_have_jax_layout(jax_step):
    _, variables, _ = jax_step
    want = convert_flax_variables(jax.tree.map(np.asarray, variables))
    spec = get_model_spec("efficientdet_lite0")
    got = DetectionPipeline.init_variables(spec)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        # tests/conftest.py turns on x64, under which flax draws the kernels
        # in float64; without it (JAX's default, the serving configuration)
        # every leaf is float32.
        assert got[k].dtype == torch.float32 and v.dtype in (torch.float32, torch.float64), k
        assert got[k].shape == v.shape, k
    other = DetectionPipeline.init_variables(spec, seed=1)
    again = DetectionPipeline.init_variables(spec, seed=0)
    w = "backbone.stem.weight"
    assert not torch.equal(got[w], other[w]) and torch.equal(got[w], again[w])
    half = DetectionPipeline.init_variables(spec, dtype=torch.bfloat16)
    assert {v.dtype for v in half.values()} == {torch.bfloat16}


def test_main_runs_entry_and_dryrun_on_two_cpu_devices(capsys):
    entry.main(["--device", "cpu", "--devices", "cpu,cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("entry ok: {'count': (4,), 'scores': (4, 25)")
    assert out[1] == "dryrun ok"


def test_dryrun_refuses_a_relay_that_moves_a_box(monkeypatch):
    from vbt_tpu_torch.parallel import time_shard

    sharded = time_shard.track_video_time_sharded

    def moved(*args, **kw):
        out = sharded(*args, **kw)
        return out._replace(box=out.box + 1e-3)

    monkeypatch.setattr(time_shard, "track_video_time_sharded", moved)
    with pytest.raises(AssertionError, match="relay: boxes"):
        entry.dryrun_multichip(2, devices=[torch.device("cpu")] * 2)
