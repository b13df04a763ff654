"""Train-mode BatchNorm and the activation after it on Hopper: the wrapper of
``csrc/batchnorm_act.cu``, its plain version and its autograd Function.

flax's train-mode BatchNorm on NCHW: the batch's mean and variance over N,
H and W in float32 (float64 for float64 inputs), the variance the fast one
(``mean(x^2) - mean(x)^2``, clamped at 0) and biased, eps 1e-3; the running
statistics updated in place, ``r <- 0.99 r + 0.01 batch``; then the
activation, a function (None for none; the kernels apply those of
:data:`KERNEL_ACTS`).

- :func:`batchnorm_act_plain`, the plain version in torch ops, is what
  ``models/conv.py::BatchNorm`` runs in train mode off the kernels' path:
  float64, bfloat16, the CPU, a set ``reduce_stats``.
- :func:`batchnorm_act` launches the kernels for a float32 tensor on the
  card (:data:`KERNEL_DEVICE`), through :class:`BatchNormAct`, whose
  backward is two more kernels. ``BatchNorm`` decides which of the two a
  call takes; the wrapper raises on what the kernels do not take.

The forward takes the batch's mean and mean of squares from the plain
version's own float32 reductions (``x.mean``, ``(x * x).mean``): the fast
variance loses digits where a channel's mean is large against its
spread, and the train step's gradient carries that rounding forward, so
statistics summed in another order would move the step by more than
float32 rounding (``csrc/batchnorm_act.cu`` has the figures). Then three
kernels a BatchNorm (``batchnorm_act.launches``, a key each, registered
with ``utils/profiling.py::launch_counter``): the forward's normalize and
activate, which repeats the plain version's roundings, so that y equals
its y bit for bit, writes the channel's mean, variance, 1/std and the
clamp's gate and updates the running statistics; the backward's per-block
partial sums of dz and dz * xhat (float64), then dx, dw and db. They use
no atomics, so a CUDA-graph replay gives an eager call's bits.
:func:`launch_plan` picks the vector width and the blocks a channel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from vbt_tpu_torch.ops import _build
from vbt_tpu_torch.utils.profiling import launch_counter

BN_EPS = 1e-3  # EfficientNet/flax BatchNorm epsilon used throughout (csrc kEps)
BN_MOMENTUM = 0.99  # flax's convention: the weight of the old running value
#: The activations the kernels apply, by function: csrc/batchnorm_act.cu's Act.
KERNEL_ACTS = {None: 0, F.relu6: 1, F.silu: 2}
KERNEL_DEVICE = "cuda"  # the device type whose float32 tensors take the kernels
BLOCK_ELEMENTS = 16384  # a block's share of a large channel: 64 elements for each thread
MIN_BLOCK_ELEMENTS = 1024  # no channel is cut into blocks smaller than this
BLOCKS_PER_SM = 4  # the least a shape with the elements for it puts on each SM


def batchnorm_act_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        running_mean: torch.Tensor, running_var: torch.Tensor,
                        act=None, reduce_stats=None) -> torch.Tensor:
    """Train-mode BatchNorm of NCHW ``x`` and ``act``, in torch ops
    (module docstring); ``running_mean`` and ``running_var`` are updated in
    place. ``reduce_stats``, where given, takes the float activations and
    returns the (mean, var) to normalize with in place of the batch's."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if reduce_stats is None:
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    else:
        mean, var = reduce_stats(xf)
    with torch.no_grad():
        running_mean.copy_(BN_MOMENTUM * running_mean + (1 - BN_MOMENTUM) * mean)
        running_var.copy_(BN_MOMENTUM * running_var + (1 - BN_MOMENTUM) * var)
    mul = torch.rsqrt(var + BN_EPS) * weight
    y = ((xf - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]).to(x.dtype)
    return y if act is None else act(y)


def launch_plan(n: int, c: int, hw: int, sms: int, aligned: bool) -> tuple[int, int]:
    """(vector width, blocks a channel) of the kernels for an (n, c, h, w)
    tensor with ``hw = h * w`` on a card of ``sms`` SMs: 16-byte vectors
    where ``hw % 4 == 0`` and the pointers are ``aligned`` to 16 bytes; a
    channel's ``n * hw`` elements in blocks of about
    :data:`BLOCK_ELEMENTS`, and more where the card would otherwise hold
    fewer than :data:`BLOCKS_PER_SM` blocks an SM, none under
    :data:`MIN_BLOCK_ELEMENTS` elements. A small plane thus takes one
    block a channel."""
    m = n * hw
    want = max(-(-m // BLOCK_ELEMENTS), -(-BLOCKS_PER_SM * sms // c))
    return (4 if aligned and hw % 4 == 0 else 1), max(1, min(want, m // MIN_BLOCK_ELEMENTS))


@functools.cache
def _launchers():
    """``vbt_bn_act_forward`` and ``vbt_bn_act_backward`` of the built
    library, their C signatures declared."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return (_build.bind("batchnorm_act", "vbt_bn_act_forward", [p] * 9 + [i] * 6 + [f, f, p]),
            _build.bind("batchnorm_act", "vbt_bn_act_backward", [p] * 9 + [i] * 6 + [p]))


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan(*tensors: torch.Tensor) -> tuple[int, int, int, int, int]:
    """(n, c, hw, vec, split) of the kernels for the activations
    ``tensors`` they read (the first gives the shape; outputs are fresh
    allocations, aligned)."""
    n, c, h, w = tensors[0].shape
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    vec, split = launch_plan(n, c, h * w, _sms(tensors[0].device), aligned)
    return n, c, h * w, vec, split


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_forward(x, mean, meansq, weight, bias, running_mean, running_var, y, stats, plan,
                    act):
    """Queue the forward's kernel (module docstring) on the current stream."""
    with torch.cuda.device(x.device):
        err = _launchers()[0](
            x.data_ptr(), mean.data_ptr(), meansq.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(), y.data_ptr(),
            stats.data_ptr(), *plan, KERNEL_ACTS[act], BN_MOMENTUM, 1 - BN_MOMENTUM,
            _stream(x.device))
    if err != 0:
        raise RuntimeError(f"batchnorm_act forward launch failed: cudaError {err}")


def _launch_backward(x, dy, weight, bias, stats, partial, dx, dw, db, plan, act):
    """Queue the backward's two kernels (module docstring) on the current stream."""
    with torch.cuda.device(x.device):
        err = _launchers()[1](
            x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(), stats.data_ptr(),
            partial.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(), *plan,
            KERNEL_ACTS[act], _stream(x.device))
    if err != 0:
        raise RuntimeError(f"batchnorm_act backward launch failed: cudaError {err}")


def _check(x: torch.Tensor, params: dict, act) -> None:
    if x.device.type != KERNEL_DEVICE:
        raise ValueError(f"the kernels run on {KERNEL_DEVICE}, got a tensor on {x.device}")
    if act not in KERNEL_ACTS:
        raise ValueError(f"the kernels apply none, F.relu6 or F.silu, got {act!r}")
    if x.dim() != 4 or 0 in x.shape:
        raise ValueError(f"want a non-empty NCHW tensor, got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"the kernels take float32, got {x.dtype}")
    if x.numel() // x.shape[1] >= 2 ** 31:
        raise ValueError(f"the kernels index a channel with 32 bits; got shape {tuple(x.shape)}")
    for name, t in params.items():
        if t.dtype != torch.float32 or t.shape != (x.shape[1],):
            raise TypeError(f"{name}: want float32 ({x.shape[1]},), got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous tensor on {x.device}, got {t.device}")


def _forward(x, weight, bias, running_mean, running_var, act):
    """The forward: the plain version's reductions, then the kernel.
    Returns (y, stats), stats (4, C) the channels' mean, variance, 1/std and
    the clamp's gate (1 where the raw variance is >= 0); the running
    statistics are updated in place."""
    mean = x.mean(dim=(0, 2, 3))
    meansq = (x * x).mean(dim=(0, 2, 3))
    plan = _plan(x)
    y = torch.empty_like(x)
    stats = torch.empty(4, x.shape[1], dtype=torch.float32, device=x.device)
    _launch_forward(x, mean, meansq, weight, bias, running_mean, running_var, y, stats, plan,
                    act)
    batchnorm_act.launches["forward_apply"] += 1
    return y, stats


def _backward(x, dy, weight, bias, stats, act):
    """The backward's two launches: (dx, dw, db)."""
    plan = _plan(x, dy)
    dx = torch.empty_like(x)
    dw, db = torch.empty_like(weight), torch.empty_like(bias)
    partial = torch.empty(x.shape[1] * plan[4], 2, dtype=torch.float64, device=x.device)
    _launch_backward(x, dy, weight, bias, stats, partial, dx, dw, db, plan, act)
    batchnorm_act.launches["backward_partials"] += 1
    batchnorm_act.launches["backward_apply"] += 1
    return dx, dw, db


class BatchNormAct(torch.autograd.Function):
    """The kernels' forward and backward (module docstring). ``forward``
    returns y and keeps x, the parameters and the channel statistics for
    ``backward``, which returns the gradients of x, the weight and the
    bias."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, act):
        y, stats = _forward(x, weight, bias, running_mean, running_var, act)
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.act = act
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, bias, stats = ctx.saved_tensors
        return (*_backward(x, dy.contiguous(), weight, bias, stats, ctx.act),
                None, None, None)


def batchnorm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  running_mean: torch.Tensor, running_var: torch.Tensor,
                  act=None) -> torch.Tensor:
    """Train-mode BatchNorm of NCHW float32 ``x`` on the card and ``act``
    (:func:`batchnorm_act_plain`'s function) by the kernels. The running
    statistics are updated in place; ``x``, ``weight`` and ``bias`` get
    gradients through :class:`BatchNormAct`."""
    _check(x, {"weight": weight, "bias": bias, "running_mean": running_mean,
               "running_var": running_var}, act)
    return BatchNormAct.apply(x.contiguous(), weight, bias, running_mean, running_var, act)


launch_counter(batchnorm_act, keys=("forward_apply", "backward_partials", "backward_apply"))
