"""Post-training int8 quantization of the dense convolutions.

Port of ``vbt_tpu.models.quant``: the stand-in for the reference's
deployed post-training-int8 TFLite artifact. The scheme is the JAX
package's, step for step:

- weights: symmetric int8 per output channel, ``s_w = max(maxabs(w),
  1e-12) / 127`` from the **float32** kernel;
- activations: symmetric int8 per tensor, ``s_in = max(act_scale, 1e-8) /
  127``, where ``act_scale`` is the running max of ``|x|`` over the
  calibration batches (in the input's dtype, cast to float32);
- ``round`` (half to even) and a clip to +-127;
- the product accumulated in int32, then ``acc * (s_in * s_w)`` in float32,
  cast to the working dtype, plus the bias in that dtype;
- grouped (depthwise) convolutions stay in the floating dtype.

Modes (``OFF``, ``CALIBRATE``, ``INT8``) are set on the modules
(:func:`set_mode`), not passed through ``forward``. Every dense
:class:`~vbt_tpu_torch.models.conv.Conv2dSame` carries an ``act_scale``
buffer, ``None`` until calibrated or loaded, so float checkpoints load
unchanged; :func:`freeze_int8` quantizes its float32 weight once, before
a pipeline casts the model to its working dtype, and :func:`cast_model`
keeps every scale float32 through that cast.

The int8 product (:func:`int8_conv`) on an already SAME-padded input:

- a CUDA tensor goes through ``torch._int_mm`` (:func:`int8_conv_gemm`):
  the JAX package leaves this product to XLA outside any Pallas kernel, so
  a library int8 GEMM takes its place. A 1x1 convolution is a (B*H*W,
  Cin) x (Cin, Cout) product on channels-last rows; the stem (3x3, stride
  2) is unfolded first (``F.unfold`` has no int8 kernel, so the quantized
  values are unfolded as float, where they are exact small integers, and
  cast back). The card's ``_int_mm`` takes only some shapes
  (:func:`int_mm_shape`): operands are padded with zeros to multiples of
  16 and the result sliced back. What ``_int_mm`` refuses raises; nothing falls back
  to the float path;
- a CPU tensor takes the plain version (:func:`int8_conv_plain`): the same
  int32 accumulator from ``F.conv2d`` in float64 over the int8 values,
  exact because every sum stays far below 2^53.

Quantize and dequantize are plain elementwise torch ops; a fused
quantize / int8 GEMM / dequantize kernel is later performance work.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vbt_tpu_torch.utils.profiling import launch_counter

OFF = "off"
CALIBRATE = "calibrate"
INT8 = "int8"
MODES = (OFF, CALIBRATE, INT8)
QMAX = 127.0
# Buffers of a dense conv that hold scales: float32 whatever the working dtype.
SCALE_BUFFERS = ("act_scale", "w_scale")


def input_scale(act_scale: torch.Tensor) -> torch.Tensor:
    """``s_in = max(act_scale, 1e-8) / 127`` in float32."""
    return torch.clamp_min(act_scale.float(), 1e-8) / QMAX


def weight_scales(weight: torch.Tensor) -> torch.Tensor:
    """Per-output-channel ``s_w = max(maxabs(w), 1e-12) / 127`` of an OIHW
    float32 weight, shape (O,)."""
    w_max = weight.float().abs().amax(dim=(1, 2, 3))
    return torch.clamp_min(w_max, 1e-12) / QMAX


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8; ``x`` is taken in
    float32 and ``round`` is half to even, as ``jnp.round``."""
    return torch.clamp(torch.round(x.float() / scale), -QMAX, QMAX).to(torch.int8)


def dequantize(acc: torch.Tensor, s_in: torch.Tensor, s_w: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The int32 NCHW accumulator -> ``acc * (s_in * s_w)`` in float32, cast
    to ``dtype``."""
    return (acc.float() * (s_in * s_w).view(1, -1, 1, 1)).to(dtype)


def quantize_weight(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An OIHW float32 weight -> (int8 OIHW weight, float32 (O,) scales)."""
    if weight.dtype != torch.float32:
        raise ValueError(f"int8 weights are quantized from the float32 kernel, got {weight.dtype}")
    s_w = weight_scales(weight)
    return quantize(weight, s_w.view(-1, 1, 1, 1)), s_w


def int8_conv_plain(x_q: torch.Tensor, w_q: torch.Tensor, stride: int) -> torch.Tensor:
    """VALID int8 convolution of padded NCHW ``x_q`` with OIHW ``w_q`` ->
    the int32 NCHW accumulator, through ``F.conv2d`` in float64 (every
    product and partial sum is an integer below 2^53, so it is exact)."""
    acc = F.conv2d(x_q.double(), w_q.double(), stride=stride)
    return acc.to(torch.int32)


def int_mm_shape(m: int, k: int, n: int) -> tuple[int, int, int]:
    """The padded (m, k, n) of an (m, k) x (k, n) ``torch._int_mm`` on the
    card: every side up to a multiple of 16, m at least 32. torch asks only
    m > 16 and k, n multiples of 8, but cuBLAS (called without a workspace)
    refuses some such shapes: on the H100, padding to multiples of 8 left
    (102400, 64, 40), lite0's box head at P3 and B = 64, refused, and
    multiples of 16 in the "TN" layout of :func:`int8_matmul` took every
    lite0 product at B = 64 and B = 1 (``tools/probe_int_mm.py``)."""
    up16 = lambda v: -(-v // 16) * 16  # noqa: E731
    return max(up16(m), 32), up16(k), up16(n)


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` for (m, k) int8 rows and an (n, k) int8 weight -> (m, n)
    int32 by ``torch._int_mm``, both zero-padded to :func:`int_mm_shape`
    and the result sliced back. cuBLAS takes the int8 product only with
    the first operand row-major and the second the transpose of a
    row-major matrix (the "TN" layout), which ``w.t()`` is. Counts its
    calls in ``int8_matmul.calls``."""
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = int_mm_shape(m, k, n)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    int8_matmul.calls += 1
    return torch._int_mm(a.contiguous(), w.contiguous().t())[:m, :n]


launch_counter(int8_matmul, "calls")


def gemm_shape(x_shape: tuple[int, ...], w_shape: tuple[int, ...],
               stride: int) -> tuple[int, int, int]:
    """(m, k, n) of the product :func:`int8_conv_gemm` makes for a padded
    NCHW input of ``x_shape`` and an OIHW weight of ``w_shape``."""
    b, c, h, w = x_shape
    o, _, kh, kw = w_shape
    ho, wo = (h - kh) // stride + 1, (w - kw) // stride + 1
    return b * ho * wo, c * kh * kw, o


def int8_conv_gemm(x_q: torch.Tensor, w_q: torch.Tensor, stride: int) -> torch.Tensor:
    """VALID int8 convolution as one :func:`int8_matmul` on channels-last
    rows (im2col first unless 1x1 at stride 1) -> the int32 accumulator,
    NCHW-shaped (channels-last memory)."""
    b, c, h, w = x_q.shape
    o, _, k, _ = w_q.shape
    ho, wo = (h - k) // stride + 1, (w - k) // stride + 1
    if k == 1 and stride == 1:
        rows = x_q.permute(0, 2, 3, 1).reshape(b * h * w, c)
    else:
        # (B, C*k*k, L) in (c, kh, kw) order, the order of w_q.reshape(o, -1).
        cols = F.unfold(x_q.float(), k, stride=stride)
        rows = cols.transpose(1, 2).reshape(b * ho * wo, c * k * k).to(torch.int8)
    acc = int8_matmul(rows, w_q.reshape(o, -1))
    return acc.view(b, ho, wo, o).permute(0, 3, 1, 2)


def int8_conv(x_q: torch.Tensor, w_q: torch.Tensor, stride: int) -> torch.Tensor:
    """The int32 accumulator of a VALID int8 convolution: ``_int_mm`` on a
    CUDA tensor, the plain version on a CPU one."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"int8 convolution of {x_q.dtype} by {w_q.dtype}")
    if x_q.device.type == "cuda":
        return int8_conv_gemm(x_q, w_q, stride)
    if x_q.device.type == "cpu":
        return int8_conv_plain(x_q, w_q, stride)
    raise ValueError(f"no int8 convolution on {x_q.device}")


# -- the modes on a model -----------------------------------------------------


def dense_convs(model: nn.Module) -> dict[str, nn.Module]:
    """Every dense conv of ``model`` (the modules with an ``act_scale``
    buffer slot), by name."""
    return {name: m for name, m in model.named_modules() if "act_scale" in m._buffers}


def set_mode(model: nn.Module, mode: str) -> None:
    """Put every dense conv in ``mode``; ``INT8`` first quantizes the
    weights (:func:`freeze_int8`) and needs every conv calibrated."""
    if mode not in MODES:
        raise ValueError(f"quant mode must be one of {MODES}, got {mode!r}")
    if mode == INT8:
        freeze_int8(model)
    for conv in dense_convs(model).values():
        conv.quant = mode


def freeze_int8(model: nn.Module) -> None:
    """Quantize every dense conv's float32 weight into the non-persistent
    buffers ``w_int8`` (OIHW) and ``w_scale`` (O,). Raises if a conv has no
    ``act_scale``, as the JAX package does without a ``quant`` collection."""
    for name, conv in dense_convs(model).items():
        if conv.act_scale is None:
            raise ValueError(f"int8 mode requires a calibrated act_scale ({name} has none): "
                             "calibrate the pipeline first")
        w_q, s_w = quantize_weight(conv.weight.detach())
        conv.register_buffer("w_int8", w_q, persistent=False)
        conv.register_buffer("w_scale", s_w, persistent=False)


@torch.inference_mode()
def calibrate(model: nn.Module, batches) -> dict[str, torch.Tensor]:
    """Run ``batches`` through ``model`` on the float path, recording each
    dense conv's running max of ``|x|``; returns ``{"<conv>.act_scale":
    float32 scalar}``. The model's modes and scales are left as they were."""
    convs = dense_convs(model)
    saved = {name: (conv.quant, conv.act_scale) for name, conv in convs.items()}
    try:
        for conv in convs.values():
            conv.quant, conv.act_scale = CALIBRATE, None
        for images in batches:
            model(images)
        return {f"{name}.act_scale": conv.act_scale for name, conv in convs.items()}
    finally:
        for name, conv in convs.items():
            conv.quant, conv.act_scale = saved[name]


def make_room_for_scales(model: nn.Module, state_dict: dict) -> None:
    """Give every dense conv named by an ``<conv>.act_scale`` key of
    ``state_dict`` a float32 ``act_scale`` buffer, so that a strict load
    fills it; raises on a key that names no dense conv."""
    convs = dense_convs(model)
    for key in state_dict:
        name, _, leaf = key.rpartition(".")
        if leaf != "act_scale":
            continue
        if name not in convs:
            raise KeyError(f"{key!r} names no dense convolution of the model")
        convs[name].act_scale = torch.zeros((), dtype=torch.float32)


def cast_model(model: nn.Module, device: torch.device, dtype: torch.dtype) -> nn.Module:
    """``model.to(device, dtype)`` with every scale buffer kept float32: a
    bf16 ``act_scale`` would move every ``s_in``."""
    scales = {name: buf for name, buf in model.named_buffers()
              if name.rpartition(".")[2] in SCALE_BUFFERS}
    model.to(device=device, dtype=dtype)
    for name, buf in scales.items():
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, buf.to(device=device, dtype=torch.float32))
    return model
