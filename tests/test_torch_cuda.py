"""Tests that need a CUDA card: the NMS and fused-MBConv kernels against
their plain versions on the card, and the served bf16 pipelines (XLA and
turbo backbones) launching them.

They skip without a card. On the machine with one, run them without the
JAX test configuration (this file imports neither jax nor vbt_tpu):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are the kernels' contracts. NMS: counts exact, scores 1e-6,
boxes 1e-5. Fused MBConv: 2e-4 absolute plus relative in float32 (f32 sums
in another order); 2e-2 absolute plus relative in bfloat16, where the other
order can flip the bf16 rounding of an intermediate (one step is 2^-8
relative).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack")
B, K = 64, 512


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _boxes(rng, b=B, k=K):
    yx = rng.uniform(0.0, 0.8, size=(b, k, 2))
    hw = rng.uniform(0.02, 0.3, size=(b, k, 2))
    return np.concatenate([yx, yx + hw], -1).astype(np.float32)


def _case(name):
    rng = np.random.default_rng(0)
    logits = rng.normal(-2.0, 3.0, size=(B, K)).astype(np.float32)
    boxes, kw = _boxes(rng), {}
    if name == "ties":
        logits[:, ::13] = 3.0
    elif name == "all_suppressed":
        boxes = np.broadcast_to(boxes[:, :1], boxes.shape).copy()
    elif name == "threshold_above_all":
        logits = np.minimum(logits, 6.0)
        kw = {"score_threshold": 0.999}
    elif name == "k300_with_pads":
        logits, boxes = logits[:, :300].copy(), boxes[:, :300].copy()
        logits[:, :20] = -np.inf
        logits[:, 20:40] = -100.0
    elif name == "stops_at_zero":
        logits[:] = -np.inf
        logits[:, [5, 17, 40]] = [1.0, 2.0, 3.0]
    return logits, boxes, kw


@pytest.mark.parametrize("name", ["random", "ties", "all_suppressed", "threshold_above_all",
                                  "k300_with_pads", "stops_at_zero"])
def test_nms_kernel_matches_plain(dev, name):
    from vbt_tpu_torch.ops.nms_cuda import nms
    from vbt_tpu_torch.ops.postprocess import nms_plain

    logits, boxes, kw = _case(name)
    logits, boxes = torch.from_numpy(logits).to(dev), torch.from_numpy(boxes).to(dev)
    before = nms.launches
    got = nms(logits, boxes, **kw)
    torch.cuda.synchronize()
    assert nms.launches == before + 1
    want = nms_plain(logits, boxes, **kw)
    assert torch.equal(got[0], want[0])
    assert (got[1] - want[1]).abs().max().item() <= 1e-6
    assert (got[2] - want[2]).abs().max().item() <= 1e-5


def test_nms_kernel_rejects_what_it_cannot_take(dev):
    from vbt_tpu_torch.ops.nms_cuda import nms

    logits = torch.zeros(B, K, device=dev)
    boxes = torch.zeros(B, K, 4, device=dev)
    with pytest.raises(ValueError):
        nms(logits.t().contiguous().t(), boxes)  # not contiguous
    with pytest.raises(ValueError):
        nms(torch.zeros(B, K + 1, device=dev), torch.zeros(B, K + 1, 4, device=dev))
    with pytest.raises(ValueError):
        nms(logits, boxes.cpu())


def test_served_pipeline_launches_kernel(dev):
    from vbt_tpu_torch.io.synthetic import plate_frames
    from vbt_tpu_torch.ops.nms_cuda import nms
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

    pipe = DetectionPipeline.from_model_arg(CKPT, device=dev)
    assert pipe.dtype == torch.bfloat16 and pipe.use_kernel
    before = nms.launches
    det = pipe.detect_batch(plate_frames(8, 240, 320, seed=3))
    rows, valid = pipe.detections_to_tracker_inputs(det, 0.5)
    assert nms.launches == before + 1
    assert valid[:, 0].all() and np.isfinite(rows).all()


# (Cin, Cmid, Cout, H, W, k, stride): lite0's g1_b1 (stride 1, residual) and
# g1_b0 (stride 2) at 320, as the turbo backbone runs them.
K2_SHAPES = [(24, 144, 24, 80, 80, 3, 1), (16, 96, 24, 160, 160, 3, 2)]
K2_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def _k2_case(dev, shape, dtype, b=4):
    from vbt_tpu_torch.ops.fused_mbconv import FusedBlockParams

    cin, cmid, cout, h, w, k, s = shape
    rng = np.random.default_rng(1)

    def r(*sh, scale=1.0, dt=torch.float32):
        return torch.from_numpy((rng.normal(size=sh) * scale).astype(np.float32)).to(dev, dt)

    p = FusedBlockParams(we=r(cmid, cin, scale=0.3, dt=dtype), be=r(cmid, 1),
                         wd=r(cmid, k * k, scale=0.5), bd=r(cmid, 1),
                         wp=r(cout, cmid, scale=0.2, dt=dtype), bp=r(cout, 1), h=h, w=w,
                         kernel=k, stride=s, residual=s == 1 and cin == cout)
    return r(b, cin, h * w, dt=dtype), p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K2_SHAPES)
def test_fused_mbconv_kernel_matches_plain(dev, shape, dtype):
    from vbt_tpu_torch.ops.fused_mbconv import fused_mbconv, fused_mbconv_plain

    x, p = _k2_case(dev, shape, dtype)
    before = fused_mbconv.launches
    got = fused_mbconv(x, p)
    torch.cuda.synchronize()
    assert fused_mbconv.launches == before + 1
    want = fused_mbconv_plain(x, p)
    assert got.shape == want.shape and got.dtype == dtype
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= K2_TOL[dtype] * (1 + want.float().abs())).all()), diff.max().item()


def test_fused_mbconv_kernel_rejects_what_it_cannot_take(dev):
    from vbt_tpu_torch.ops.fused_mbconv import fused_mbconv

    x, p = _k2_case(dev, K2_SHAPES[0], torch.bfloat16)
    with pytest.raises(ValueError):
        fused_mbconv(x.cpu(), p)  # weights on the card, x on the CPU
    xt = x.reshape(4, 24, 80, 80).transpose(2, 3)  # NCHW shape, not contiguous
    with pytest.raises(ValueError):
        fused_mbconv(xt, p)


def test_turbo_pipeline_launches_both_kernels(dev):
    from vbt_tpu_torch.io.synthetic import plate_frames
    from vbt_tpu_torch.ops.fused_mbconv import fused_mbconv
    from vbt_tpu_torch.ops.nms_cuda import nms
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

    pipe = DetectionPipeline.from_model_arg(CKPT, device=dev, backbone="turbo")
    assert pipe.dtype == torch.bfloat16 and len(pipe.turbo.fused_names) == 5
    k2, k1 = fused_mbconv.launches, nms.launches
    det = pipe.detect_batch(plate_frames(8, 240, 320, seed=3))
    rows, valid = pipe.detections_to_tracker_inputs(det, 0.5)
    assert fused_mbconv.launches == k2 + 5 and nms.launches == k1 + 1
    assert valid[:, 0].all() and np.isfinite(rows).all()
