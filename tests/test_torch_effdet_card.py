"""EfficientDet-D3 served on the card against the plain float32 reference
(``tests/plain/effdet.py``), at its published size.

Card only (``cuda`` marker; skipped without a card). On the card, without
the JAX test configuration (this file imports neither jax nor vbt_tpu):

    python -m pytest --noconftest -m cuda tests/test_torch_effdet_card.py

``DetectionPipeline`` serves D3 in bf16 at 896 px, B = 4, on seeded
weights (``init_variables``, seed 0), on synthetic plate frames; the
reference runs the same weights in float32 with TF32 off on the same
frames (its own preprocess). ``gap`` is the worse over deltas and logits of
the largest absolute difference over the reference's largest magnitude.
The bf16 lane must read at most ``BOUND``; the int8 lane (calibrated on the
same frames), the nearest precision below, must read more, so the bound
tells the served precision from a lower one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

BATCH, SIZE = 4, 896
# Between the bf16 lane's reading and the int8 lane's on the card, the
# deltas' in both (logits on seeded weights sit at the class prior's bias,
# 0.0003 in both lanes): bf16 0.0192-0.0247, int8 0.1200-0.1253 over the
# frame seeds 5, 6, 7 (NVIDIA H100 80GB HBM3, 700 W).
BOUND = 0.05


def gaps(lane: str, seed: int = 5) -> dict:
    """The lane's ``gap`` and its parts on ``seed``'s frames."""
    from plain import effdet as plain

    from benchmark.reference.model.preprocess import preprocess_frames
    from vbt_tpu_torch.io.synthetic import plate_frames
    from vbt_tpu_torch.models import get_model_spec
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

    spec = get_model_spec("efficientdet_d3")
    weights = DetectionPipeline.init_variables(spec, seed=0)
    frames = plate_frames(BATCH, SIZE, SIZE, seed=seed)
    pipe = DetectionPipeline(spec, weights, device="cuda")
    if lane == "int8":
        pipe = pipe.calibrate(frames)
    with torch.inference_mode():
        served = [t.float() for t in pipe.forward(frames)]
        images = preprocess_frames(torch.from_numpy(frames).cuda(), SIZE)
        with plain.tf32_off():
            want = plain.forward(plain.D_SPECS["efficientdet_d3"],
                                 {k: v.cuda() for k, v in weights.items()}, images)[:2]
    out = {}
    for name, s, w in zip(("deltas", "logits"), served, want):
        out[name] = float((s - w).abs().max() / w.abs().max())
        out[f"{name}_mean"] = float((s - w).abs().mean() / w.abs().mean())
    out["gap"] = max(out["deltas"], out["logits"])
    return out


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def test_the_served_bf16_heads_hold_the_reference(card):
    got = gaps("bf16")
    assert got["gap"] <= BOUND, got


def test_the_int8_lane_does_not(card):
    got = gaps("int8")
    assert got["gap"] > BOUND, got
    assert np.isfinite(got["gap"])
