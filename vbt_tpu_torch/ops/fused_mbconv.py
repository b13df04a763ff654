"""Fused MBConv block on Hopper: the wrapper of ``csrc/fused_mbconv.cu`` and
its plain PyTorch version.

Replaces ``vbt_tpu/ops/fused_mbconv.py`` (kernel ``_mbconv_kernel``,
called through ``fused_mbconv``). One call runs a whole inference MBConv block with
its BatchNorms folded into the weights (:class:`FusedBlockParams`):

1. 1x1 expand: f32 accumulation of ``we @ x``, ``+ be``, clip to [0, 6],
   cast to the compute dtype (the dtype of ``wp``);
2. k x k depthwise with XLA's SAME padding at stride 1 or 2: starting from
   ``bd``, ``+ wd[:, tap] * h`` in f32 over the taps in row-major order,
   where an expanded value outside the image counts as 0; clip, cast;
3. 1x1 project: f32 accumulation of ``wp @ h2``, ``+ bp``, ``+ x`` in f32
   when ``residual``, cast to the dtype of ``x``.

Those are the Pallas kernel's rounding points, and :func:`fused_mbconv_plain`
keeps them. The layout is the JAX one: ``x`` is (B, Cin, H*W), or the same
bytes as contiguous NCHW, and the output is (B, Cout, Ho*Wo).

Left out, because they were Mosaic's constraints and not the block's
arithmetic: ``to_phase_planes`` (the kernel strides through its input
itself), ``_VMEM_BUDGET`` / ``_pick_num_chunks`` and the ``num_chunks`` grid
axis (the kernel loops over Cmid chunks inside one block, so the chunking is
not visible to the caller).

:func:`fused_mbconv` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises; there is no fallback.
``fused_mbconv.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from vbt_tpu_torch.models.conv import same_pads
from vbt_tpu_torch.ops import _build

KERNEL_SIZES = (3, 5)  # the depthwise sizes the CUDA kernel is built for
MAX_COUT = 128  # project accumulators held in registers (csrc/fused_mbconv.cu kMaxCout)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class FusedBlockParams:
    """BN-folded weights and geometry of one fused MBConv block."""

    we: torch.Tensor | None  # (Cmid, Cin) compute dtype; None without expand
    be: torch.Tensor | None  # (Cmid, 1) f32
    wd: torch.Tensor  # (Cmid, k*k) f32, tap index ty * k + tx
    bd: torch.Tensor  # (Cmid, 1) f32
    wp: torch.Tensor  # (Cout, Cmid) compute dtype
    bp: torch.Tensor  # (Cout, 1) f32
    h: int
    w: int
    kernel: int
    stride: int
    residual: bool

    @property
    def has_expand(self) -> bool:
        return self.we is not None

    @property
    def out_hw(self) -> tuple[int, int]:
        return -(-self.h // self.stride), -(-self.w // self.stride)


def fold_bn(kernel: np.ndarray, bn_scale, bn_bias, bn_mean, bn_var, eps=1e-3):
    """Fold inference BatchNorm into conv weights: returns (w_scaled_factor,
    bias) where y = conv(x, kernel * factor) + bias equals BN(conv(x))."""
    factor = np.asarray(bn_scale) / np.sqrt(np.asarray(bn_var) + eps)
    bias = np.asarray(bn_bias) - np.asarray(bn_mean) * factor
    return factor, bias


def _check(x: torch.Tensor, p: FusedBlockParams) -> tuple[int, int, int, int]:
    """Validate a call; returns (B, Cin, Cmid, Cout)."""
    cmid, cout = p.wd.shape[0], p.wp.shape[0]
    cin = p.we.shape[1] if p.has_expand else cmid
    if p.kernel not in KERNEL_SIZES or p.stride not in (1, 2) or p.h < 1 or p.w < 1:
        raise ValueError(f"fused MBConv takes k in {KERNEL_SIZES}, stride 1 or 2, H, W >= 1; "
                         f"got k={p.kernel}, stride={p.stride}, H={p.h}, W={p.w}")
    if p.residual and (p.stride != 1 or cin != cout):
        raise ValueError(f"a residual needs stride 1 and Cin == Cout, got stride "
                         f"{p.stride}, {cin} -> {cout}")
    spatial = {3: (p.h * p.w,), 4: (p.h, p.w)}.get(x.dim())
    if x.shape[1:2] != (cin,) or tuple(x.shape[2:]) != spatial:
        raise ValueError(f"want x (B, {cin}, {p.h}*{p.w}) or (B, {cin}, {p.h}, {p.w}), "
                         f"got {tuple(x.shape)}")
    if tuple(p.wd.shape) != (cmid, p.kernel ** 2) or tuple(p.wp.shape) != (cout, cmid):
        raise ValueError(f"want wd ({cmid}, {p.kernel ** 2}) and wp ({cout}, {cmid}), "
                         f"got {tuple(p.wd.shape)} and {tuple(p.wp.shape)}")
    if p.has_expand and (p.be is None or p.we.shape[0] != cmid):
        raise ValueError(f"want we ({cmid}, Cin) and be ({cmid}, 1)")
    sizes = ((p.be, cmid), (p.bd, cmid), (p.bp, cout))
    if any(t is not None and t.numel() != n for t, n in sizes):
        raise ValueError(f"want be and bd of {cmid} values and bp of {cout}")
    weights = [t for t in (p.we, p.wp) if t is not None]
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype for t in weights):
        raise TypeError(f"want x, we and wp all float32 or all bfloat16, got x {x.dtype}, "
                        f"weights {[t.dtype for t in weights]}")
    biases = [t for t in (p.be, p.wd, p.bd, p.bp) if t is not None]
    if any(t.dtype != torch.float32 for t in biases):
        raise TypeError("be, wd, bd and bp must be float32")
    if any(t.device != x.device for t in weights + biases):
        raise ValueError(f"x on {x.device}, weights on {[str(t.device) for t in weights + biases]}")
    return x.shape[0], cin, cmid, cout


def fused_mbconv_plain(x: torch.Tensor, p: FusedBlockParams) -> torch.Tensor:
    """The block in plain torch ops, with the kernel's rounding points.
    (B, Cin, H*W) or NCHW ``x`` -> (B, Cout, Ho*Wo) in ``x.dtype``."""
    b, cin = x.shape[:2]
    cmid = p.wd.shape[0]
    cdt = p.wp.dtype
    ho, wo = p.out_hw
    xf = x.reshape(b, cin, p.h * p.w).float()
    if p.has_expand:
        # Products of bf16 values are exact in f32, so an f32 product of the
        # upcast operands is the kernel's f32 accumulation.
        h = (torch.matmul(p.we.float(), xf) + p.be).clamp(0.0, 6.0).to(cdt)
    else:
        h = xf.to(cdt)
    # Zero padding of the expanded tensor is the kernel's mask: a tap outside
    # the image adds wd * 0.
    top, bottom = same_pads(p.h, p.kernel, p.stride)
    left, right = same_pads(p.w, p.kernel, p.stride)
    hp = F.pad(h.float().reshape(b, cmid, p.h, p.w), (left, right, top, bottom))
    acc = p.bd.reshape(1, cmid, 1, 1).expand(b, cmid, ho, wo)
    s, k = p.stride, p.kernel
    for ty in range(k):
        for tx in range(k):
            term = hp[:, :, ty:ty + (ho - 1) * s + 1:s, tx:tx + (wo - 1) * s + 1:s]
            acc = acc + p.wd[:, ty * k + tx].reshape(1, cmid, 1, 1) * term
    h2 = acc.clamp(0.0, 6.0).to(cdt).float().reshape(b, cmid, ho * wo)
    y = torch.matmul(p.wp.float(), h2) + p.bp
    if p.residual:
        y = y + xf
    return y.to(x.dtype)


@functools.cache
def _launcher():
    """``vbt_fused_mbconv_launch`` of the built library, its C signature declared."""
    fn = _build.load("fused_mbconv").vbt_fused_mbconv_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_mbconv(x: torch.Tensor, p: FusedBlockParams) -> torch.Tensor:
    """One fused MBConv block: (B, Cin, H*W) or NCHW -> (B, Cout, Ho*Wo)."""
    b, cin, cmid, cout = _check(x, p)
    if x.device.type == "cpu":
        return fused_mbconv_plain(x, p)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if cout > MAX_COUT or b == 0:
        raise ValueError(f"kernel takes B > 0 and Cout <= {MAX_COUT}, got B={b}, Cout={cout}")
    tensors = [t for t in (x, p.we, p.be, p.wd, p.bd, p.wp, p.bp) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x and the block's weights must be contiguous")
    ho, wo = p.out_hw
    out = torch.empty(b, cout, ho * wo, dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher()(
            x.data_ptr(), ptr(p.we), ptr(p.be), p.wd.data_ptr(), p.bd.data_ptr(),
            p.wp.data_ptr(), p.bp.data_ptr(), out.data_ptr(),
            b, cin, cmid, cout, p.h, p.w, p.kernel, p.stride, int(p.residual),
            int(p.has_expand), _DTYPE_CODE[x.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_mbconv kernel launch failed: cudaError {err}")
    fused_mbconv.launches += 1
    return out


fused_mbconv.launches = 0
