"""Random weights for a missing checkpoint, opted into, as in the JAX package.

``DetectionPipeline.from_model_arg(seed=, allow_random=)`` and
``run_stream(allow_random=)`` against ``vbt_tpu``'s: a --model argument
without a checkpoint is refused with JAX's ``FileNotFoundError`` text
unless ``allow_random``; then the pipeline serves the initial variables
drawn from ``seed`` (JAX's stream is not reproduced, so JAX's behaviour is
read from what it passes to its own ``init_variables``); a checkpoint that
exists is loaded whatever ``allow_random`` says; ``run_stream`` passes
``allow_random`` to ``from_model_arg`` on both sides (its lines against
JAX's are ``tests/test_torch_stream.py``'s).
"""

import io
import os

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

from vbt_tpu.cli import stream as jax_stream  # noqa: E402
from vbt_tpu.runtime.pipeline import DetectionPipeline as JaxPipeline  # noqa: E402
from vbt_tpu_torch.cli import stream as port_stream  # noqa: E402
from vbt_tpu_torch.models import get_model_spec  # noqa: E402
from vbt_tpu_torch.runtime.checkpoint import load_checkpoint  # noqa: E402
from vbt_tpu_torch.runtime.pipeline import DetectionPipeline  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack")
MISSING = "efficientdet_lite0"  # a spec name with no checkpoint beside it


def test_missing_checkpoint_is_refused_with_jax_text():
    with pytest.raises(FileNotFoundError) as want:
        JaxPipeline.from_model_arg(MISSING)
    with pytest.raises(FileNotFoundError) as got:
        DetectionPipeline.from_model_arg(MISSING, device="cpu")
    assert str(got.value) == str(want.value)
    assert "allow_random=True" in str(got.value)


def test_allow_random_serves_the_seeded_initial_variables(monkeypatch):
    drawn = []

    def jax_init(spec, seed=0, dtype=None):
        drawn.append((spec.name, seed))
        return {"template": seed}

    served = []
    monkeypatch.setattr(JaxPipeline, "init_variables", staticmethod(jax_init))
    monkeypatch.setattr(JaxPipeline, "__init__",
                        lambda self, spec, variables, **kw: served.append(variables))
    JaxPipeline.from_model_arg(MISSING, seed=3, allow_random=True)
    assert drawn == [("efficientdet_lite0", 3)] and served == [{"template": 3}]

    spec = get_model_spec(MISSING)
    pipe = DetectionPipeline.from_model_arg(MISSING, device="cpu", seed=3, allow_random=True)
    want = DetectionPipeline.init_variables(spec, 3)
    assert pipe.weights.keys() == want.keys()
    assert all(torch.equal(pipe.weights[k], v) for k, v in want.items())
    other = DetectionPipeline.from_model_arg(MISSING, device="cpu", seed=4, allow_random=True)
    assert any(not torch.equal(other.weights[k], v) for k, v in want.items())


def test_a_checkpoint_is_loaded_whatever_allow_random_says():
    want = load_checkpoint(CKPT)
    for allow in (False, True):
        pipe = DetectionPipeline.from_model_arg(CKPT, device="cpu", seed=5, allow_random=allow)
        assert all(torch.equal(pipe.weights[k], v) for k, v in want.items())


class _Asked(Exception):
    pass


@pytest.mark.parametrize("allow", [None, False, True], ids=["default", "false", "true"])
def test_run_stream_passes_allow_random(monkeypatch, allow):
    """Each side's ``run_stream`` with its ``from_model_arg`` recorded, which
    then stops the session: the same model and flag reach both."""
    asked = {}

    def recorder(side):
        def from_model_arg(cls, model, **kw):
            asked[side] = (model, kw["allow_random"])
            raise _Asked
        return classmethod(from_model_arg)

    monkeypatch.setattr(JaxPipeline, "from_model_arg", recorder("jax"))
    monkeypatch.setattr(DetectionPipeline, "from_model_arg", recorder("port"))
    kw = dict(model=MISSING, detection_threshold=0.5, chunk_size=32, plate_diameter=0.45,
              follow_id=1, out=io.StringIO())
    if allow is not None:
        kw["allow_random"] = allow
    with pytest.raises(_Asked):
        jax_stream.run_stream("unused.mp4", **kw)
    with pytest.raises(_Asked):
        port_stream.run_stream("unused.mp4", device="cpu", **kw)
    assert asked["port"] == asked["jax"] == (MISSING, bool(allow))
