"""Port preprocess against ``vbt_tpu.ops.preprocess.preprocess_frames``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vbt_tpu.ops.preprocess import preprocess_frames as jax_preprocess  # noqa: E402
from vbt_tpu_torch.ops.preprocess import preprocess_frames  # noqa: E402


def _frames(h, w, seed=0, b=2):
    return np.random.default_rng(seed).integers(0, 256, size=(b, h, w, 3), dtype=np.uint8)


def _both(frames, size, **kw):
    want = np.asarray(jax_preprocess(jnp.asarray(frames), size, dtype=jnp.float32, **kw))
    got = preprocess_frames(torch.from_numpy(frames), size, dtype=torch.float32, **kw)
    assert got.shape == (frames.shape[0], 3, size, size) and got.dtype == torch.float32
    return got.permute(0, 2, 3, 1).numpy(), want


def test_identity_size_is_exact():
    got, want = _both(_frames(64, 64), 64)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("hw,size", [((90, 160), 64), ((1080, 1920), 320), ((240, 320), 320)])
@pytest.mark.parametrize("quantize", [False, True])
def test_resize_matches_jax(hw, size, quantize):
    got, want = _both(_frames(*hw, seed=hw[0]), size, quantize_uint8=quantize)
    # Half-pixel bilinear weights are the same in both when downsampling;
    # 1e-5 covers float32 rounding of the weighted sums (values in [-1, 1]).
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_bf16_output_dtype():
    x = preprocess_frames(torch.from_numpy(_frames(48, 64)), 32, dtype=torch.bfloat16)
    assert x.dtype == torch.bfloat16 and x.shape == (2, 3, 32, 32)
