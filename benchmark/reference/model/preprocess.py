"""Frame preprocessing: uint8 NHWC frames -> normalized NCHW model input.

Port of ``vbt_tpu.ops.preprocess.preprocess_frames``: bilinear resize with
half-pixel centers and no antialiasing (``F.interpolate(align_corners=False,
antialias=False)`` gives the same weights as ``jax.image.resize`` when
downsampling; tests/test_torch_preprocess.py holds them equal), skipped at
identity size, optional uint8 floor/clip round trip, then (x - 127) / 128.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MEAN_RGB = 127.0
STDDEV_RGB = 128.0


def preprocess_frames(
    frames: torch.Tensor,
    input_size: int,
    dtype: torch.dtype = torch.float32,
    quantize_uint8: bool = False,
) -> torch.Tensor:
    """uint8 (B, H, W, 3) on any device -> (B, 3, S, S) in ``dtype``.

    The resize runs in float32 on the frames' device; the layout turns
    NCHW here, once, for the convolutions that follow.
    """
    x = frames.permute(0, 3, 1, 2).to(torch.float32)
    if tuple(frames.shape[1:3]) != (input_size, input_size):
        x = F.interpolate(x, size=(input_size, input_size), mode="bilinear",
                          align_corners=False, antialias=False)
    if quantize_uint8:
        x = torch.clamp(torch.floor(x), 0.0, 255.0)
    return ((x - MEAN_RGB) / STDDEV_RGB).to(dtype)
