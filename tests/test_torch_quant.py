"""The port's int8 lane against the JAX package's on the CPU, float32 on
both sides.

- One dense conv (``Conv2dSame`` in int8 against ``QuantConv``) on the same
  input, kernel and ``act_scale``: the quantized input and kernel and the
  int32 accumulator equal JAX's (``lax.conv_general_dilated`` with
  ``preferred_element_type=int32``) exactly; the output within 1e-6
  relative (the same integers times the same float32 scales; the bias add
  is the only rounding that may differ).
- The plain version and the ``_int_mm`` route give the same accumulator,
  and the card's padding rule (every side a multiple of 16, m at least 32;
  ``quant.int_mm_shape`` says why) holds for every int8 product of lite0 at
  320 (batch 64 and batch 1), as pure Python.
- A lite0 pipeline (``init_variables(spec, seed=3)``, as tests/test_quant.py)
  calibrated on seeded frames: every ``act_scale`` carried across equals the
  port's own calibration within 1e-5 relative. The float forwards agree to
  float32 rounding compounded over the network's depth, not exactly (flax
  computes each BatchNorm factor in float32, torch folds it in another
  order): measured 2.2e-6 at most, above 1e-6 in 40 of 68 scales.
- The int8 head outputs against JAX's int8 pipeline with the same scales:
  an activation within float32 rounding of a rounding boundary quantizes
  one step (``act_scale / 127``) apart, and later layers carry and multiply
  such flips, so two int8 lanes whose float forwards agree to 1e-6 differ
  about as much as int8 differs from float. The port alone shows it: the
  same int8 model with its float parts in float32 and in float64 (float
  outputs 2e-6 apart) gives int8 outputs 0.6 of the int8-versus-float
  difference apart. Measured here: max 1.4e-2 (deltas) and 8.5e-3
  (logits); held at 5e-2 absolute, and the mean difference at twice the
  mean int8-versus-float difference of JAX's own lane at most (a missing
  bias or a wrong scale is far outside both). The scheme itself is held
  exactly by the per-conv test above.
- Detections of the shipped lite0 on synthetic plate frames, int8 both
  sides with JAX's scales: counts equal, top score within 5e-3 and top box
  within 2e-2 of the frame (JAX's own int8 top box moves 5.4e-3 from its
  float one; the port's int8 against JAX's measured 1.1e-3 and 7.1e-3).
- The off mode is unchanged, and the refusals (int8 with the turbo
  backbone, int8 without calibration) are JAX's.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from vbt_tpu.models import get_model_spec as jax_get_model_spec  # noqa: E402
from vbt_tpu.models.quant import INT8 as JAX_INT8  # noqa: E402
from vbt_tpu.models.quant import QuantConv  # noqa: E402
from vbt_tpu.runtime.pipeline import DetectionPipeline as JaxPipeline  # noqa: E402
from vbt_tpu_torch.io.synthetic import plate_frames  # noqa: E402
from vbt_tpu_torch.models import EfficientDet, get_model_spec  # noqa: E402
from vbt_tpu_torch.models import quant as q  # noqa: E402
from vbt_tpu_torch.models.conv import Conv2dSame, conv2d_same, pad_same, same_pads  # noqa: E402
from vbt_tpu_torch.runtime.checkpoint import (  # noqa: E402
    convert_flax_variables,
    load_checkpoint,
    load_into,
)
from vbt_tpu_torch.runtime.pipeline import DetectionPipeline  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack")
SCALE_RTOL = 1e-5
HEAD_ATOL = 5e-2
TOP_SCORE_ATOL, TOP_BOX_ATOL = 5e-3, 2e-2

CONVS = {  # name: (cin, cout, kernel, stride, bias, hw)
    "stem": (3, 32, 3, 2, False, 17),
    "expand": (16, 96, 1, 1, False, 10),
    "project": (96, 24, 1, 1, False, 7),
    "class_head": (64, 9, 1, 1, True, 3),
    "box_head": (64, 36, 1, 1, True, 5),
}


def _np(tree):
    return jax.tree.map(np.asarray, dict(tree))


def _jax_quantized(x, kernel, act_scale):
    """The quantized input and kernel as ``QuantConv`` makes them
    (vbt_tpu/models/quant.py)."""
    s_in = jnp.maximum(act_scale, 1e-8) / 127.0
    w = jnp.asarray(kernel, jnp.float32)
    s_w = jnp.maximum(jnp.abs(w).max(axis=(0, 1, 2), keepdims=True), 1e-12) / 127.0
    w_q = jnp.clip(jnp.round(w / s_w), -127, 127).astype(jnp.int8)
    x_q = jnp.clip(jnp.round(jnp.asarray(x, jnp.float32) / s_in), -127, 127).astype(jnp.int8)
    return x_q, w_q


@pytest.mark.parametrize("name", sorted(CONVS))
def test_dense_conv_int8_matches_jax(name):
    cin, cout, k, stride, bias, hw = CONVS[name]
    rng = np.random.default_rng(sorted(CONVS).index(name))
    x = rng.normal(size=(2, hw, hw + 2, cin)).astype(np.float32)
    kernel = (rng.normal(size=(k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32) if bias else None
    # An act_scale below the batch's max, so the clip at +-127 is exercised.
    act_scale = np.float32(0.8 * np.abs(x).max())

    x_q, w_q = _jax_quantized(x, kernel, jnp.float32(act_scale))
    want_acc = np.asarray(lax.conv_general_dilated(
        x_q, w_q, (stride, stride), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    module = QuantConv(cout, (k, k), strides=(stride, stride), use_bias=bias, dtype=jnp.float32)
    params = {"kernel": kernel, **({"bias": b} if bias else {})}
    want = np.asarray(module.apply({"params": params, "quant": {"act_scale": act_scale}},
                                   jnp.asarray(x), quant=JAX_INT8))

    conv = Conv2dSame(cin, cout, k, stride, bias=bias)
    state = {"weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
             "act_scale": torch.tensor(act_scale)}
    if bias:
        state["bias"] = torch.from_numpy(b)
    conv.act_scale = torch.zeros(())
    conv.load_state_dict(state)
    q.set_mode(conv, q.INT8)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    s_in = q.input_scale(conv.act_scale)
    got_xq = q.quantize(xt, s_in)
    np.testing.assert_array_equal(got_xq.permute(0, 2, 3, 1).numpy(), np.asarray(x_q))
    np.testing.assert_array_equal(conv.w_int8.permute(2, 3, 1, 0).numpy(), np.asarray(w_q))
    padded = pad_same(got_xq, k, stride)
    for acc in (q.int8_conv_plain(padded, conv.w_int8, stride),
                q.int8_conv_gemm(padded, conv.w_int8, stride)):
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), want_acc)
    with torch.no_grad():
        got = conv(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def _lite0_gemm_shapes(batch: int) -> set[tuple[int, int, int]]:
    """(m, k, n) of every int8 product of lite0 at 320, from the input shape
    of each dense conv in a float forward."""
    model = EfficientDet(get_model_spec("efficientdet_lite0"))
    load_into(model, load_checkpoint(CKPT))
    shapes = set()

    def hook(conv, args, _out):
        b, c, h, w = args[0].shape
        pads = [sum(same_pads(s, conv.kernel, conv.stride)) for s in (h, w)]
        shapes.add(q.gemm_shape((batch, c, h + pads[0], w + pads[1]), conv.weight.shape,
                                conv.stride))

    for conv in q.dense_convs(model).values():
        conv.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros(1, 3, 320, 320))
    return shapes


@pytest.mark.parametrize("batch", [64, 1])
def test_int_mm_padding_rule_for_every_lite0_shape(batch):
    shapes = _lite0_gemm_shapes(batch)
    ks = {k for _, k, _ in shapes}
    ns = {n for _, _, n in shapes}
    assert 27 in ks and 9 in ns and 36 in ns  # the stem, the class and box heads
    assert (min(m for m, _, _ in shapes) == 9) == (batch == 1)  # P7, 3x3
    for m, k, n in shapes:
        mp, kp, np_ = q.int_mm_shape(m, k, n)
        assert mp > 16 and mp % 16 == 0 and kp % 16 == 0 and np_ % 16 == 0
        assert m <= mp < max(m + 16, 33) and k <= kp < k + 16 and n <= np_ < n + 16
        if batch == 64:
            assert mp == m  # a map at B = 64 pays no copy of its rows


def test_gemm_route_equals_plain_on_padded_shapes():
    """``_int_mm`` on the CPU through the same padding and slicing."""
    rng = np.random.default_rng(5)
    for (b, c, h, o, k, s) in [(1, 3, 7, 32, 3, 2), (1, 64, 3, 9, 1, 1), (2, 40, 5, 36, 1, 1),
                               (1, 1152, 1, 192, 1, 1)]:
        x = torch.from_numpy(rng.integers(-127, 128, size=(b, c, h, h), dtype=np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, size=(o, c, k, k), dtype=np.int8))
        np.testing.assert_array_equal(q.int8_conv_gemm(x, w, s).numpy(),
                                      q.int8_conv_plain(x, w, s).numpy())


@pytest.fixture(scope="module")
def seeded():
    """JAX's lite0 (seed 3) float and calibrated int8 pipelines, the port's
    float pipeline from the same variables and the seeded frames."""
    spec = jax_get_model_spec("efficientdet_lite0")
    variables = JaxPipeline.init_variables(spec, seed=3)
    jax_float = JaxPipeline(spec=spec, variables=variables, use_pallas=False)
    frames = np.random.default_rng(2).integers(0, 255, size=(2, 320, 320, 3), dtype=np.uint8)
    jax_int8 = jax_float.calibrate(frames)
    port = DetectionPipeline(get_model_spec("efficientdet_lite0"),
                             convert_flax_variables(_np(variables)), device="cpu")
    return jax_float, jax_int8, port, frames


def _scales(state):
    return {k: float(v) for k, v in state.items() if k.endswith(".act_scale")}


def test_calibrated_scales_match_jax(seeded):
    _, jax_int8, port, frames = seeded
    carried = _scales(convert_flax_variables(_np(jax_int8.variables)))
    qport = port.calibrate(frames)
    own = _scales(qport.weights)
    assert len(carried) == len(own) == len(q.dense_convs(qport.model)) == 68
    assert set(carried) == set(own)
    for key, want in carried.items():
        assert want > 0
        assert abs(own[key] - want) <= SCALE_RTOL * want, key
    assert qport.quant == "int8" and all(v.dtype == torch.float32 for k, v in
                                         qport.model.state_dict().items() if "act_scale" in k)


def test_int8_heads_match_jax(seeded):
    jax_float, jax_int8, _, frames = seeded
    qport = DetectionPipeline(get_model_spec("efficientdet_lite0"),
                              convert_flax_variables(_np(jax_int8.variables)), device="cpu",
                              quant="int8")
    want = [np.asarray(a) for a in jax_int8._forward(jax_int8.variables, frames)]
    base = [np.asarray(a) for a in jax_float._forward(jax_float.variables, frames)]
    got = [t.numpy() for t in qport.forward(frames)]
    for g, w, f in zip(got, want, base):
        diff = np.abs(g - w)
        assert diff.max() <= HEAD_ATOL
        assert diff.mean() <= 2 * np.abs(w - f).mean()


def test_off_mode_unchanged_and_calibration_leaves_the_pipeline(seeded):
    """The float path is the plain convolution, bit for bit, and calibrating
    changes neither the pipeline's outputs nor its state."""
    jax_float, _, port, frames = seeded
    before = port.forward(frames)
    keys = set(port.model.state_dict())
    port.calibrate(frames)
    after = port.forward(frames)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert set(port.model.state_dict()) == keys and not any("act_scale" in k for k in keys)
    assert all(c.quant == q.OFF and c.act_scale is None for c in q.dense_convs(port.model).values())
    conv = port.model.backbone.stem
    x = torch.randn(1, 3, 9, 9)
    with torch.no_grad():
        assert torch.equal(conv(x), conv2d_same(x, conv.weight, None, 2))
    want = [np.asarray(a) for a in jax_float._forward(jax_float.variables, frames)]
    for g, w in zip(before, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-5)


def test_shipped_lite0_int8_detections_match_jax():
    frames = plate_frames(4, 320, 480, seed=1)
    jax_float = JaxPipeline.from_model_arg(CKPT, use_pallas=False)
    jax_int8 = jax_float.calibrate(frames)
    port = DetectionPipeline(get_model_spec("efficientdet_lite0_whole"),
                             convert_flax_variables(_np(jax_int8.variables)), device="cpu",
                             quant="int8")
    want, got = jax_int8.detect_batch(frames), port.detect_batch(frames)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    assert (np.asarray(want.scores[:, 0]) > 0.9).all()
    np.testing.assert_allclose(got.scores[:, 0].numpy(), np.asarray(want.scores[:, 0]),
                               atol=TOP_SCORE_ATOL)
    np.testing.assert_allclose(got.boxes[:, 0].numpy(), np.asarray(want.boxes[:, 0]),
                               atol=TOP_BOX_ATOL)


def test_refusals_match_jax(seeded):
    jax_float, _, port, frames = seeded
    with pytest.raises(ValueError):
        JaxPipeline(spec=jax_float.spec, variables=jax_float.variables, quant="int8",
                    backbone="turbo")
    with pytest.raises(ValueError, match="backbone"):
        DetectionPipeline(port.spec, port.weights, device="cpu", quant="int8", backbone="turbo")
    turbo = DetectionPipeline(port.spec, port.weights, device="cpu", backbone="turbo")
    with pytest.raises(ValueError, match="xla"):
        turbo.calibrate(frames)
    # int8 without calibration: JAX raises at the first forward, the port at construction.
    uncalibrated = JaxPipeline(spec=jax_float.spec, variables=jax_float.variables,
                               use_pallas=False, quant="int8")
    with pytest.raises(ValueError):
        uncalibrated.detect_batch(frames[:1])
    with pytest.raises(ValueError, match="calibrat"):
        DetectionPipeline(port.spec, port.weights, device="cpu", quant="int8")
    conv = Conv2dSame(4, 8, 1)
    conv.quant = q.INT8
    with pytest.raises(ValueError, match="calibrated"):
        conv(torch.zeros(1, 4, 2, 2))
    with pytest.raises(ValueError):
        DetectionPipeline(port.spec, port.weights, device="cpu", quant="int4")


def test_scales_stay_float32_through_the_cast(seeded):
    _, jax_int8, _, _ = seeded
    state = convert_flax_variables(_np(jax_int8.variables))
    pipe = DetectionPipeline(get_model_spec("efficientdet_lite0"), state, device="cpu",
                             dtype=torch.bfloat16, quant="int8")
    stem = pipe.model.backbone.stem
    assert pipe.model.backbone.g1_b0.expand.weight.dtype == torch.bfloat16
    assert stem.act_scale.dtype == stem.w_scale.dtype == torch.float32
    assert stem.w_int8.dtype == torch.int8
    assert float(stem.act_scale) == float(state["backbone.stem.act_scale"])
    # The int8 weights come from the float32 kernel, not the bf16 copy.
    want, _ = q.quantize_weight(state["backbone.stem.weight"].float())
    assert torch.equal(stem.w_int8, want)
