"""Port turbo backbone and turbo pipeline against the JAX package on the CPU.

- ``TurboBackbone`` / ``turbo_forward`` against JAX ``turbo_backbone``
  (Pallas in interpret mode) plus ``neck_and_heads``, with the shipped lite0
  weights on one 64x64 image and ``fuse_min_spatial=64``, so that five
  blocks fuse. Taps and head outputs are held at 5e-4 absolute plus
  relative, as ``tests/test_fused_mbconv.py`` holds the JAX turbo forward
  against the flax model: f32 sums in another order through 16 blocks, the
  BiFPN and the heads.
- the fuse rule against the JAX rule for the shipped variants at their
  input sizes (5 blocks for lite0, 7 for lite2).
- ``DetectionPipeline(backbone="turbo", device="cpu")`` against the port's
  XLA pipeline at 320: counts exact, scores and boxes within 1e-4 (the two
  forwards differ by f32 summation order, ~1e-5 on logits). With
  ``test_torch_pipeline_track.py::test_detect_batch_matches_jax`` this holds
  the turbo pipeline against JAX.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.serialization  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vbt_tpu.models.efficientdet import EfficientDet as JaxEfficientDet  # noqa: E402
from vbt_tpu.models.efficientdet import get_model_spec as jax_get_model_spec  # noqa: E402
from vbt_tpu.models.efficientnet_lite import scaled_blocks as jax_scaled_blocks  # noqa: E402
from vbt_tpu.models.turbo import FUSE_MIN_SPATIAL as JAX_FUSE_MIN_SPATIAL  # noqa: E402
from vbt_tpu.models.turbo import turbo_backbone as jax_turbo_backbone  # noqa: E402
from vbt_tpu_torch.io.synthetic import plate_frames  # noqa: E402
from vbt_tpu_torch.models.efficientdet import EfficientDet, get_model_spec  # noqa: E402
from vbt_tpu_torch.models.turbo import (  # noqa: E402
    FUSE_MIN_SPATIAL,
    TurboBackbone,
    fold_block_params,
    turbo_backbone,
    turbo_forward,
)
from vbt_tpu_torch.ops.fused_mbconv import fused_mbconv  # noqa: E402
from vbt_tpu_torch.runtime.checkpoint import load_checkpoint, load_into  # noqa: E402
from vbt_tpu_torch.runtime.pipeline import DetectionPipeline  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models", "{}_whole.msgpack")
SIZE, FUSE_AT = 64, 64
ATOL = RTOL = 5e-4


def _port_model(name: str) -> EfficientDet:
    model = EfficientDet(get_model_spec(name))
    return load_into(model, load_checkpoint(CKPT.format(name))).eval()


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(1).uniform(-1, 1, size=(1, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_outputs(image):
    with open(CKPT.format("efficientdet_lite0"), "rb") as f:
        variables = flax.serialization.msgpack_restore(f.read())
    model = JaxEfficientDet(jax_get_model_spec("efficientdet_lite0"), dtype=jnp.float32)
    feats = jax_turbo_backbone(variables, jnp.asarray(image), "lite0", dtype=jnp.float32,
                               interpret=True, fuse_min_spatial=FUSE_AT)
    deltas, logits = model.apply(variables, feats, train=False, method="neck_and_heads")
    return ({k: np.asarray(v) for k, v in feats.items()}, np.asarray(deltas), np.asarray(logits))


@pytest.fixture(scope="module")
def port_outputs(image):
    model = _port_model("efficientdet_lite0")
    x = torch.from_numpy(image).permute(0, 3, 1, 2)
    turbo = TurboBackbone(model.backbone, (SIZE, SIZE), torch.float32, "cpu",
                          fuse_min_spatial=FUSE_AT)
    with torch.no_grad():
        feats = turbo(x)
        deltas, logits = turbo_forward(model, turbo, x)
        once = turbo_backbone(model.backbone, x, fuse_min_spatial=FUSE_AT)
    nhwc = {k: v.permute(0, 2, 3, 1).numpy() for k, v in feats.items()}
    return nhwc, deltas.numpy(), logits.numpy(), turbo.fused_names, once, feats


def test_five_blocks_fuse_at_64(port_outputs):
    assert port_outputs[3] == ["g1_b0", "g1_b1", "g2_b0", "g2_b1", "g3_b0"]


def test_turbo_backbone_function_equals_module(port_outputs):
    once, feats = port_outputs[4], port_outputs[5]
    for level in (3, 4, 5):
        assert torch.equal(once[level], feats[level])


@pytest.mark.parametrize("level", [3, 4, 5])
def test_turbo_taps_match_jax(jax_outputs, port_outputs, level):
    want, got = jax_outputs[0][level], port_outputs[0][level]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("which", ["deltas", "logits"])
def test_turbo_forward_matches_jax(jax_outputs, port_outputs, which):
    i = 1 if which == "deltas" else 2
    want, got = jax_outputs[i], port_outputs[i]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _jax_fused_names(variant: str, size: int) -> list[str]:
    """The JAX rule (``vbt_tpu/models/turbo.py`` turbo_backbone), walked."""
    h = w = -(-size // 2)
    names = []
    for gi, group in enumerate(jax_scaled_blocks(variant)):
        for ri in range(group.repeats):
            stride = group.stride if ri == 0 else 1
            if h * w >= JAX_FUSE_MIN_SPATIAL and group.expand != 1:
                names.append(f"g{gi}_b{ri}")
            if stride == 2:
                h, w = -(-h // 2), -(-w // 2)
    return names


@pytest.mark.parametrize("name,count", [("efficientdet_lite0", 5), ("efficientdet_lite2", 7)])
def test_fuse_rule_matches_jax(name, count):
    assert FUSE_MIN_SPATIAL == JAX_FUSE_MIN_SPATIAL
    spec = get_model_spec(name)
    turbo = TurboBackbone(_port_model(name).backbone, (spec.input_size, spec.input_size),
                          torch.float32, "cpu")
    want = _jax_fused_names(spec.backbone, spec.input_size)
    assert turbo.fused_names == want and len(want) == count


def test_turbo_pipeline_matches_xla_pipeline():
    ckpt = CKPT.format("efficientdet_lite0")
    xla = DetectionPipeline.from_model_arg(ckpt, device="cpu")
    turbo = DetectionPipeline.from_model_arg(ckpt, device="cpu", backbone="turbo")
    assert turbo.turbo is not None and len(turbo.turbo.fused_names) == 5
    frames = plate_frames(4, 240, 320, seed=2)
    before = fused_mbconv.launches
    want, got = xla.detect_batch(frames), turbo.detect_batch(frames)
    assert fused_mbconv.launches == before  # the CPU lane runs the plain version
    assert torch.equal(got.count, want.count)
    np.testing.assert_allclose(got.scores.numpy(), want.scores.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes.numpy(), atol=1e-4, rtol=0)
    rows, valid = turbo.detections_to_tracker_inputs(got, 0.5)
    assert valid[:, 0].all() and np.isfinite(rows).all()


def test_pipeline_refuses_unknown_backbone():
    with pytest.raises(ValueError, match="backbone"):
        DetectionPipeline.from_model_arg(CKPT.format("efficientdet_lite0"), device="cpu",
                                         backbone="fused")


def test_turbo_folds_onto_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the no-card refusal is what is tested")
    backbone = _port_model("efficientdet_lite0").backbone
    with pytest.raises(RuntimeError, match="cuda"):
        TurboBackbone(backbone, (SIZE, SIZE))
    with pytest.raises(RuntimeError, match="cuda"):
        fold_block_params(backbone.g1_b0, SIZE // 2, SIZE // 2, 3, 2, False)
