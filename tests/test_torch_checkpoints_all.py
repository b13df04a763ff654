"""Every shipped checkpoint through the port's forward against the flax
model: EfficientDet-Lite0, 1 and 2, base and ``_whole``, batch 1 at the
spec's input size (320, 384, 448), float32 on the CPU, one random image
each. ``(deltas, logits)`` within 1e-4 absolute plus 1e-5 relative, the
bounds of tests/test_torch_model.py (convolution sums in another order;
a layout or padding error moves them by 0.1 or more)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.serialization  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vbt_tpu.models.efficientdet import EfficientDet as JaxEfficientDet  # noqa: E402
from vbt_tpu.models.efficientdet import get_model_spec as jax_get_model_spec  # noqa: E402
from vbt_tpu_torch.models.efficientdet import EfficientDet, get_model_spec  # noqa: E402
from vbt_tpu_torch.runtime.checkpoint import load_checkpoint, load_into  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = [f"efficientdet_lite{i}{w}" for i in range(3) for w in ("", "_whole")]
ATOL, RTOL = 1e-4, 1e-5


@pytest.mark.parametrize("name", NAMES)
def test_shipped_checkpoint_heads_match_flax(name):
    path = os.path.join(REPO, "models", f"{name}.msgpack")
    spec = get_model_spec(name)
    assert spec.input_size == jax_get_model_spec(name).input_size
    size = spec.input_size
    image = np.random.default_rng(0).uniform(-1.0, 1.0, (1, size, size, 3)).astype(np.float32)
    with open(path, "rb") as f:
        variables = flax.serialization.msgpack_restore(f.read())
    want = JaxEfficientDet(jax_get_model_spec(name)).apply(variables, jnp.asarray(image))
    model = load_into(EfficientDet(spec), load_checkpoint(path)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(image).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[0] == 1
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
