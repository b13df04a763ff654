"""Fused MBConv block on Hopper: the wrapper of ``csrc/fused_mbconv_mma.cu``
and ``csrc/fused_mbconv.cu``, their launch plan and their plain PyTorch version.

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

Two kernels compute the block on the card, and :func:`launch_plan` says
which one a call goes to, from its dtype and shape alone:

- ``"mma"`` (``csrc/fused_mbconv_mma.cu``): both 1x1 products on the tensor
  cores (``mma.sync`` on bf16, f32 sums). It serves every bfloat16 block
  that has an expand conv, Cin (at most 48) and Cout (at most 96) multiples
  of 8 and Cmid a multiple of 48: every block the turbo backbone fuses in
  EfficientDet-Lite0, 1 and 2.
- ``"fma"`` (``csrc/fused_mbconv.cu``): the products as f32 FMA loops. It
  serves float32, where it agrees with the plain version to the order of an
  f32 sum (the tensor cores would mean TF32), and the bfloat16 blocks the
  ``"mma"`` kernel does not take (ragged channel counts, Cin above 48, no
  expand conv).

``fused_mbconv(x, p, variant="fma")`` asks for the FMA kernel on a bfloat16
block, to time one against the other; asking for ``"mma"`` on a block it
does not take raises. Nothing reacts to a failed launch.

:func:`fused_mbconv` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises; there is no fallback.
``fused_mbconv.launches`` counts kernel launches, and
``fused_mbconv.launches_by_variant`` the same launches by kernel.
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
from vbt_tpu_torch.utils.profiling import launch_counter

KERNEL_SIZES = (3, 5)  # the depthwise sizes the CUDA kernels are built for
MAX_COUT = 128  # project accumulators held in registers (csrc/fused_mbconv.cu kMaxCout)
MAX_SMEM = 232448  # dynamic shared memory a block can have on Hopper, bytes
_SMEM_PER_SM, _SMEM_PER_CTA = 233472, 1024  # an SM's shared memory; what each CTA adds to its own
VARIANTS = ("mma", "fma")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/fused_mbconv_mma.cu: 6 warps, Cmid in chunks of 48, tile rows padded by
# 8 bf16 values, 8 m16n8 project accumulators a warp; tiles it is built for.
_MMA_THREADS, _MMA_CHUNK, _MMA_ROW_PAD, _MMA_UNITS = 192, 48, 8, 8
_MMA_MAX_CIN = 48  # the expand keeps three k-steps of 16 channels in registers (kMaxCin)
_MMA_TILES = ((8, 8), (8, 16))  # 8x8 always fits; 8x16 serves stride 1 (fewer recomputed halos)
# csrc/fused_mbconv.cu: 8 warps, 8x8 tiles, Cmid in chunks of 32.
_FMA_THREADS, _FMA_CHUNK, _FMA_TILE = 256, 32, 8


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


@dataclass(frozen=True)
class LaunchPlan:
    """How one block is launched: which kernel, its tile of output positions,
    its Cmid chunk, its threads and dynamic shared memory, and the most
    output channels its accumulators hold."""

    variant: str
    tile_h: int
    tile_w: int
    chunk: int
    threads: int
    smem_bytes: int
    max_cout: int

    def tile_origins(self, ho: int, wo: int) -> list[tuple[int, int]]:
        """First output row and column of every CTA's tile, in grid order."""
        return [(y, x) for y in range(0, ho, self.tile_h) for x in range(0, wo, self.tile_w)]


def _halo(tile: int, kernel: int, stride: int) -> int:
    return (tile - 1) * stride + kernel


def mma_takes(dtype: torch.dtype, cin: int, cmid: int, cout: int, has_expand: bool) -> bool:
    """Whether the tensor-core kernel takes a block of this dtype and these channels."""
    return (dtype == torch.bfloat16 and has_expand and cin % 8 == 0 and 0 < cin <= _MMA_MAX_CIN
            and cout % 8 == 0 and 0 < cout <= _mma_max_cout(*_MMA_TILES[0])
            and cmid % _MMA_CHUNK == 0)


def _mma_max_cout(tile_h: int, tile_w: int) -> int:
    return 8 * (_MMA_UNITS * (_MMA_THREADS // 32) // (tile_h * tile_w // 16))


def _mma_tile(cin: int, cout: int, kernel: int, stride: int) -> tuple[int, int]:
    """8x16 output tiles at stride 1, where neighbouring tiles' halos overlap
    most (an 8x8 tile expands 1.56x the positions for k3 and 2.25x for k5,
    an 8x16 tile 1.41x and 1.88x), if the accumulators hold Cout and three
    CTAs of it still fit an SM's shared memory; else 8x8."""
    wide = _MMA_TILES[1]
    fits = _mma_smem(*wide, cin, cout, kernel, stride) <= _SMEM_PER_SM // 3 - _SMEM_PER_CTA
    return wide if stride == 1 and cout <= _mma_max_cout(*wide) and fits else _MMA_TILES[0]


def _mma_smem(tile_h: int, tile_w: int, cin: int, cout: int, kernel: int, stride: int) -> int:
    """csrc/fused_mbconv_mma.cu smem_bytes(): x halo, expanded chunk and
    depthwise output as bf16, two weight buffers, a flag a halo row."""
    kp = -(-cin // 16) * 16 + _MMA_ROW_PAD
    pitch = _MMA_CHUNK + _MMA_ROW_PAD
    halo = _halo(tile_h, kernel, stride) * _halo(tile_w, kernel, stride)
    halo_rows = -(-halo // 16) * 16
    weights = (_MMA_CHUNK * kp * 2 + cout * pitch * 2 + _MMA_CHUNK * kernel ** 2 * 4
               + 2 * _MMA_CHUNK * 4)
    return (2 * (halo_rows * kp + halo_rows * pitch + tile_h * tile_w * pitch) + 2 * weights
            + halo_rows)


def _fma_smem(cin: int, cout: int, kernel: int, stride: int) -> int:
    """csrc/fused_mbconv.cu smem_floats(), in bytes: f32 tiles and one chunk's weights."""
    halo = _halo(_FMA_TILE, kernel, stride) ** 2
    return 4 * (cin * _FMA_CHUNK + cin * halo + _FMA_CHUNK * halo + _FMA_CHUNK * _FMA_TILE ** 2
                + cout * _FMA_CHUNK + _FMA_CHUNK * kernel ** 2 + 2 * _FMA_CHUNK)


def launch_plan(dtype: torch.dtype, cin: int, cmid: int, cout: int, h: int, w: int, kernel: int,
                stride: int, has_expand: bool = True, variant: str | None = None) -> LaunchPlan:
    """The launch of one block, from its dtype and shape alone.

    ``variant=None`` is the rule: ``"mma"`` where :func:`mma_takes` holds,
    else ``"fma"``. A named variant is taken as asked, and raises
    ``ValueError`` for a block that kernel does not take; so does a block
    neither kernel has the shared memory or the accumulators for.
    """
    if variant is None:
        variant = "mma" if mma_takes(dtype, cin, cmid, cout, has_expand) else "fma"
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS} or None, got {variant!r}")
    if variant == "mma":
        if not mma_takes(dtype, cin, cmid, cout, has_expand):
            raise ValueError(
                f"the mma kernel takes bfloat16 blocks with an expand conv, Cin <= "
                f"{_MMA_MAX_CIN} and Cout <= {_mma_max_cout(*_MMA_TILES[0])} multiples of 8 "
                f"and Cmid a multiple of {_MMA_CHUNK}; got {dtype}, {cin}->{cmid}->{cout}, "
                f"expand={has_expand}")
        tile_h, tile_w = _mma_tile(cin, cout, kernel, stride)
        plan = LaunchPlan("mma", tile_h, tile_w, _MMA_CHUNK, _MMA_THREADS,
                          _mma_smem(tile_h, tile_w, cin, cout, kernel, stride),
                          _mma_max_cout(tile_h, tile_w))
    else:
        plan = LaunchPlan("fma", _FMA_TILE, _FMA_TILE, _FMA_CHUNK, _FMA_THREADS,
                          _fma_smem(cin, cout, kernel, stride), MAX_COUT)
    if cout > plan.max_cout or plan.smem_bytes > MAX_SMEM:
        raise ValueError(f"the {variant} kernel takes Cout <= {plan.max_cout} and "
                         f"{MAX_SMEM} bytes of shared memory; {cin}->{cmid}->{cout} k{kernel} "
                         f"s{stride} needs {plan.smem_bytes}")
    return plan


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
def _launcher(variant: str):
    """The C launch function of a variant's built library, its signature declared."""
    if variant == "mma":
        return _build.bind("fused_mbconv_mma", "vbt_fused_mbconv_mma_launch",
                           [ctypes.c_void_p] * 8 + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    return _build.bind("fused_mbconv", "vbt_fused_mbconv_launch",
                       [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p])


def fused_mbconv(x: torch.Tensor, p: FusedBlockParams,
                 variant: str | None = None) -> torch.Tensor:
    """One fused MBConv block: (B, Cin, H*W) or NCHW -> (B, Cout, Ho*Wo).

    ``variant`` names the kernel (``"mma"`` or ``"fma"``); ``None`` takes
    :func:`launch_plan`'s rule. On the CPU the plain version runs whatever
    the variant, but a variant the block cannot have still raises.

    ``x`` is contiguous, or, for the ``"mma"`` kernel, a (B, Cin, H, W)
    tensor in ``torch.channels_last`` memory. The kernel then reads a
    position's channels as one run, and gives its output the same way: the
    returned (B, Cout, Ho*Wo) tensor has channel stride 1, so its reshape to
    (B, Cout, Ho, Wo) is a channels-last tensor and no copy."""
    b, cin, cmid, cout = _check(x, p)
    if variant is not None or x.device.type == "cuda":
        plan = launch_plan(x.dtype, cin, cmid, cout, p.h, p.w, p.kernel, p.stride, p.has_expand,
                           variant)
    if x.device.type == "cpu":
        return fused_mbconv_plain(x, p)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if b == 0:
        raise ValueError("kernel takes B > 0")
    weights = [t for t in (p.we, p.be, p.wd, p.bd, p.wp, p.bp) if t is not None]
    channels_last = (plan.variant == "mma" and x.dim() == 4 and not x.is_contiguous()
                     and x.is_contiguous(memory_format=torch.channels_last))
    if not (x.is_contiguous() or channels_last) or not all(t.is_contiguous() for t in weights):
        raise ValueError("the block's weights must be contiguous, and x contiguous or, for the "
                         "mma kernel, (B, C, H, W) in channels-last memory")
    if plan.variant == "mma" and any(t.data_ptr() % 16 for t in (x, *weights)):
        raise ValueError("the mma kernel takes 16-byte aligned x and weights")
    ho, wo = p.out_hw
    if channels_last:
        out = torch.empty(b, ho * wo, cout, dtype=x.dtype, device=x.device).transpose(1, 2)
    else:
        out = torch.empty(b, cout, ho * wo, dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    pointers = (x.data_ptr(), ptr(p.we), ptr(p.be), p.wd.data_ptr(), p.bd.data_ptr(),
                p.wp.data_ptr(), p.bp.data_ptr(), out.data_ptr())
    shape = (b, cin, cmid, cout, p.h, p.w, p.kernel, p.stride, int(p.residual))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.variant == "mma":
            err = _launcher("mma")(*pointers, *shape, int(channels_last), plan.tile_h,
                                   plan.tile_w, plan.smem_bytes, stream)
        else:
            err = _launcher("fma")(*pointers, *shape, int(p.has_expand), _DTYPE_CODE[x.dtype],
                                   stream)
    if err != 0:
        raise RuntimeError(f"fused_mbconv {plan.variant} kernel launch failed: cudaError {err}")
    fused_mbconv.launches += 1
    fused_mbconv.launches_by_variant[plan.variant] += 1
    return out


launch_counter(fused_mbconv)
launch_counter(fused_mbconv, "launches_by_variant", VARIANTS)
