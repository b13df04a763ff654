"""Port EfficientDet-Lite0 forward against the flax model, shipped weights,
float32 on the CPU: backbone taps, BiFPN levels, then (deltas, logits)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.serialization  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vbt_tpu.models.efficientdet import EfficientDet as JaxEfficientDet  # noqa: E402
from vbt_tpu.models.efficientdet import get_model_spec as jax_get_model_spec  # noqa: E402
from vbt_tpu_torch.models.bifpn import _downsample2x, _upsample2x  # noqa: E402
from vbt_tpu_torch.models.conv import same_pads  # noqa: E402
from vbt_tpu_torch.models.efficientdet import EfficientDet, get_model_spec  # noqa: E402
from vbt_tpu_torch.runtime.checkpoint import load_checkpoint, load_into  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack")
NAME = "efficientdet_lite0_whole"
# Convolution sums run in another order in torch than in XLA; measured
# differences are ~1e-5 on activations up to ~14, so 1e-4 absolute plus
# 1e-5 relative leaves headroom without hiding a layout or padding error
# (those give O(0.1-1) differences).
ATOL, RTOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.uniform(-1.0, 1.0, size=(2, 320, 320, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_outputs(images):
    """One eager flax forward shared by every test here."""
    with open(CKPT, "rb") as f:
        variables = flax.serialization.msgpack_restore(f.read())
    model = JaxEfficientDet(jax_get_model_spec(NAME))
    x = jnp.asarray(images, jnp.float32)
    taps = model.apply(variables, x, method=lambda m, x: m.backbone(x, False, "off"))
    fpn = model.apply(variables, taps, method=lambda m, f: m.fpn(f, False, "off"))
    out = model.apply(variables, taps, method=lambda m, f: m.neck_and_heads(f, False, "off"))
    np_ = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return np_(taps), np_(fpn), tuple(np.asarray(o) for o in out)


@pytest.fixture(scope="module")
def torch_outputs(images):
    model = EfficientDet(get_model_spec(NAME))
    load_into(model, load_checkpoint(CKPT))
    model.eval()
    with torch.no_grad():
        x = torch.from_numpy(images).permute(0, 3, 1, 2)
        taps = model.backbone(x)
        fpn = model.fpn(taps)
        out = model(x)
    nhwc = lambda d: {k: v.permute(0, 2, 3, 1).numpy() for k, v in d.items()}  # noqa: E731
    return nhwc(taps), nhwc(fpn), tuple(o.numpy() for o in out)


@pytest.mark.parametrize("level", [3, 4, 5])
def test_backbone_taps(jax_outputs, torch_outputs, level):
    want, got = jax_outputs[0][level], torch_outputs[0][level]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("level", [3, 4, 5, 6, 7])
def test_bifpn_levels(jax_outputs, torch_outputs, level):
    want, got = jax_outputs[1][level], torch_outputs[1][level]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("which", ["deltas", "logits"])
def test_head_outputs(jax_outputs, torch_outputs, which):
    i = ["deltas", "logits"].index(which)
    want, got = jax_outputs[2][i], torch_outputs[2][i]
    assert got.shape == want.shape == (2, 19206, 4 if i == 0 else 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("size,stride,kernel,want", [
    (320, 2, 3, (0, 1)), (5, 2, 3, (1, 1)), (40, 1, 3, (1, 1)), (20, 2, 5, (1, 2)),
])
def test_same_padding_is_xla(size, stride, kernel, want):
    assert same_pads(size, kernel, stride) == want


def test_resample_index_maps():
    from vbt_tpu.models.bifpn import _downsample2x as jax_down
    from vbt_tpu.models.bifpn import _upsample2x as jax_up

    x = np.random.default_rng(1).normal(size=(1, 5, 5, 2)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    up = _upsample2x(torch.from_numpy(x[:, :3, :3]).permute(0, 3, 1, 2), (5, 5))
    assert np.array_equal(up.permute(0, 2, 3, 1).numpy(), np.asarray(jax_up(jnp.asarray(x[:, :3, :3]), (5, 5))))
    down = _downsample2x(xt).permute(0, 2, 3, 1).numpy()
    assert down.shape == (1, 3, 3, 2)
    assert np.array_equal(down, np.asarray(jax_down(jnp.asarray(x))))
