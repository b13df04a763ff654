"""Port checkpoint loading and anchors against the JAX package (exact)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.serialization  # noqa: E402
import jax  # noqa: E402

from vbt_tpu.models.anchors import AnchorConfig as JaxAnchorConfig  # noqa: E402
from vbt_tpu.models.anchors import generate_anchors as jax_generate_anchors  # noqa: E402
from vbt_tpu_torch.models.anchors import AnchorConfig, feat_sizes, generate_anchors  # noqa: E402
from vbt_tpu_torch.models.efficientdet import EfficientDet, get_model_spec  # noqa: E402
from vbt_tpu_torch.runtime.checkpoint import (  # noqa: E402
    convert_flax_variables,
    load_into,
    msgpack_restore,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack")
LITE0_LEAVES = 576


@pytest.fixture(scope="module")
def raw_bytes():
    with open(CKPT, "rb") as f:
        return f.read()


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_msgpack_reader_equals_flax(raw_bytes):
    ours = dict(_flat(msgpack_restore(raw_bytes)))
    ref = dict(_flat(flax.serialization.msgpack_restore(raw_bytes)))
    assert ours.keys() == ref.keys()
    assert len(ours) == LITE0_LEAVES
    for key, want in ref.items():
        got = ours[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert np.array_equal(got, want), key


def test_msgpack_reader_scalars_and_containers():
    # The subset flax writes beyond float arrays: ints, floats, bools, nil,
    # strings, nested maps, numpy scalars and non-f32 arrays.
    tree = {
        "a": {"b": np.arange(6, dtype=np.int32).reshape(2, 3), "c": np.float64(2.5)},
        "d": np.array([1.5, -2.0], np.float16),
        "e": np.array(True),
    }
    data = flax.serialization.msgpack_serialize(tree)
    got = dict(_flat(msgpack_restore(data)))
    want = dict(_flat(flax.serialization.msgpack_restore(data)))
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), key
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key


def test_msgpack_reader_rejects_truncated(raw_bytes):
    with pytest.raises(ValueError):
        msgpack_restore(raw_bytes[:1000])


def test_convert_covers_every_leaf(raw_bytes):
    variables = msgpack_restore(raw_bytes)
    state = convert_flax_variables(variables)
    model = EfficientDet(get_model_spec("efficientdet_lite0_whole"))
    assert len(state) == LITE0_LEAVES
    assert set(state) == set(model.state_dict())  # none unused, none missing
    load_into(model, state)
    # Kernels land transposed HWIO -> OIHW; depthwise (kh, kw, 1, C) too.
    stem = variables["params"]["backbone"]["stem"]["kernel"]
    assert torch.equal(model.backbone.stem.weight, torch.from_numpy(stem.transpose(3, 2, 0, 1)))
    dw = variables["params"]["backbone"]["g1_b0"]["depthwise"]["kernel"]
    assert model.backbone.g1_b0.depthwise.weight.shape == (dw.shape[3], 1, dw.shape[0], dw.shape[1])
    bn = variables["batch_stats"]["fpn"]["cell0"]["td_p3"]["conv"]["BatchNorm_0"]["var"]
    assert torch.equal(model.fpn.cell0.td_p3.conv.bn.running_var, torch.from_numpy(bn))


def test_load_into_rejects_mismatch(raw_bytes):
    state = convert_flax_variables(msgpack_restore(raw_bytes))
    model = EfficientDet(get_model_spec("efficientdet_lite0_whole"))
    missing = dict(state)
    missing.pop("backbone.stem.weight")
    with pytest.raises(KeyError):
        load_into(model, missing)
    extra = dict(state, **{"backbone.extra.weight": torch.zeros(1)})
    with pytest.raises(KeyError):
        load_into(model, extra)
    bad = dict(state, **{"backbone.stem.weight": torch.zeros(32, 3, 5, 5)})
    with pytest.raises(ValueError):
        load_into(model, bad)
    # A lite1 model cannot take lite0 weights.
    with pytest.raises((KeyError, ValueError)):
        load_into(EfficientDet(get_model_spec("efficientdet_lite1")), state)


def test_convert_rejects_unknown_leaf():
    with pytest.raises(KeyError):
        convert_flax_variables({"params": {"x": {"weird": np.zeros(2, np.float32)}}})
    # "quant" is a known collection now (a calibrated pipeline's act_scale
    # leaves); any other collection, or another leaf in it, is refused.
    with pytest.raises(KeyError):
        convert_flax_variables({"intermediates": {}})
    with pytest.raises(KeyError):
        convert_flax_variables({"quant": {"backbone": {"stem": {"kernel": np.zeros(())}}}})


@pytest.mark.parametrize("size", [320, 384, 448])
def test_anchors_equal_jax(size):
    want = jax_generate_anchors(JaxAnchorConfig(input_size=size))
    got = generate_anchors(AnchorConfig(input_size=size))
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert sum(9 * s * s for s in feat_sizes(size).values()) == got.shape[0]


@pytest.mark.parametrize("model", ["efficientdet_lite0", "efficientdet_lite1",
                                   "efficientdet_lite2", "input_size_128"])
def test_num_anchors_equals_jax(model):
    from vbt_tpu.models.anchors import num_anchors as jax_num_anchors
    from vbt_tpu.models.efficientdet import get_model_spec as jax_get_model_spec
    from vbt_tpu_torch.models.anchors import num_anchors
    from vbt_tpu_torch.models.efficientdet import get_model_spec

    if model == "input_size_128":
        cfg, want_cfg = AnchorConfig(input_size=128), JaxAnchorConfig(input_size=128)
    else:
        cfg, want_cfg = get_model_spec(model).anchor_config, jax_get_model_spec(model).anchor_config
    n = num_anchors(cfg)
    assert n == jax_num_anchors(want_cfg)
    assert n == generate_anchors(cfg).shape[0]


def test_decode_boxes_matches_jax():
    from vbt_tpu.models.anchors import decode_boxes as jax_decode
    from vbt_tpu_torch.models.anchors import decode_boxes

    rng = np.random.default_rng(0)
    anchors = generate_anchors(AnchorConfig(input_size=320))
    deltas = rng.normal(0.0, 0.3, size=(2, anchors.shape[0], 4)).astype(np.float32)
    want = np.asarray(jax_decode(jax.numpy.asarray(deltas), jax.numpy.asarray(anchors)))
    got = decode_boxes(torch.from_numpy(deltas), torch.from_numpy(anchors)).numpy()
    # exp may differ by an ulp between XLA and torch; box coordinates are
    # pixels up to ~700, so 1e-3 absolute is a few ulps of f32.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)
