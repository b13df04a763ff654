"""EfficientDet-D in plain float32 torch: the forward, the loss and the train
step, written from the published description and not from the port.

Sources: Tan, Pang and Le, "EfficientDet: Scalable and Efficient Object
Detection" (arXiv:1911.09070); google/automl ``efficientdet/hparams_config.py``
(``efficientdet-d3``, ``efficientdet-d7x``), ``efficientdet/efficientdet_arch.py``
(BiFPN nodes, heads) and ``efficientnet/efficientnet_builder.py`` (the B
series, its block strings, ``round_filters``, squeeze-excite). Every step is
written out on tensors: TF's SAME padding, batch normalization, swish as ``x
* sigmoid(x)``, the BiFPN's fusion (``fpn_weight_method``) as the paper
writes it, ``fastattn`` ``sum_i (w_i / (eps + sum_j w_j)) x_i`` with the
weights through a ReLU (D3) or ``sum`` ``sum_i x_i`` with no weights (automl's
``add_n``: D7x), the separable convolutions, and the pyramid over levels
3..``max_level`` (7; 8 in D7x, whose P8 is one more max pool of P7). The
weights are one flat dict, named as the checkpoints name them once read into torch
(``backbone.g1_b0.se.reduce.weight``, OIHW kernels), so a state dict of
any implementation of the same names can be fed in.

Departures from automl, each where the port's D family shares a design
with its lite family:

- resampling: one lateral 1x1 convolution and BatchNorm a level (P3, P4,
  P5 and the P6 source, C5), shared by every node of the first cell that
  reads the level; automl resamples once an edge;
- no drop-connect (stochastic depth) in training;
- BatchNorm as flax computes it: ``(x - mean) * (rsqrt(var + eps) *
  scale) + bias``, the batch variance its fast one, ``mean(x^2) -
  mean(x)^2`` clamped at 0 (biased), and the running statistics moved as
  ``r <- 0.99 r + 0.01 batch``;
- nearest upsampling as ``floor(i * h / H)`` and max pooling padded with
  ``-inf`` (equal to automl's at the power-of-two sizes of the D specs);
- the anchors, the target assignment, the focal and box losses, the mosaic
  augmentation and the optimizer's constants and schedule are the plain
  copies of ``benchmark/reference`` (imported, not rewritten); the optimizer
  is automl's SGD with momentum 0.9, global-norm clipping at 10 and decay
  4e-5 on the convolution kernels (automl's ``.*(kernel|weight)$``, which
  leaves out the fusion weights), with the parameter EMA.

TF32 stays off while it runs (:func:`tf32_off`).
"""

from __future__ import annotations

import contextlib
import math
import re
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.model.anchors import AnchorConfig, generate_anchors
from benchmark.reference.train.losses import detection_loss
from benchmark.reference.train.step import (MAX_GRAD_NORM, MOMENTUM, WEIGHT_DECAY,
                                            warmup_cosine_decay_schedule)
from benchmark.reference.train.targets import assign_targets

BN_EPS = 1e-3
BN_MOMENTUM = 0.99
FUSION_EPS = 1e-4
# efficientnet_builder.py's B0 table: repeats, kernel, strides, expansion,
# input and output filters, squeeze-excite ratio.
BLOCK_STRINGS = (
    "r1_k3_s11_e1_i32_o16_se0.25", "r2_k3_s22_e6_i16_o24_se0.25",
    "r2_k5_s22_e6_i24_o40_se0.25", "r3_k3_s22_e6_i40_o80_se0.25",
    "r3_k5_s11_e6_i80_o112_se0.25", "r4_k5_s22_e6_i112_o192_se0.25",
    "r1_k3_s11_e6_i192_o320_se0.25",
)
TAP_GROUPS = {3: 2, 4: 4, 5: 6}  # level -> the block group whose last output it is


@dataclass(frozen=True)
class DSpec:
    width: float
    depth: float
    input_size: int
    fpn_channels: int
    fpn_repeats: int
    head_repeats: int
    anchor_scale: float = 4.0
    num_classes: int = 1
    fusion: str = "fastattn"  # automl's fpn_weight_method: "fastattn" or "sum"
    max_level: int = 7

    @property
    def levels(self) -> tuple[int, ...]:
        return tuple(range(3, self.max_level + 1))


D_SPECS = {"efficientdet_d3": DSpec(1.2, 1.4, 896, 160, 6, 4),
           "efficientdet_d7x": DSpec(2.0, 3.1, 1536, 384, 8, 5, fusion="sum", max_level=8)}


@contextlib.contextmanager
def tf32_off():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_filters(filters: int, width: float) -> int:
    """automl's ``round_filters`` with divisor 8."""
    filters *= width
    new = max(8, int(filters + 4) // 8 * 8)
    return int(new + 8) if new < 0.9 * filters else int(new)


def blocks(spec: DSpec) -> list[dict]:
    """Every MBConv block in order: its name, group, kernel, stride,
    expansion, input, output and squeeze-excite channels."""
    out = []
    for g, text in enumerate(BLOCK_STRINGS):
        f = dict(re.fullmatch(r"([a-z]+)([\d.]+)", p).groups() for p in text.split("_"))
        reps = int(math.ceil(spec.depth * int(f["r"])))
        cin, cout = round_filters(int(f["i"]), spec.width), round_filters(int(f["o"]), spec.width)
        for r in range(reps):
            out.append({"name": f"g{g}_b{r}", "group": g, "kernel": int(f["k"]),
                        "stride": int(f["s"][0]) if r == 0 else 1, "expand": int(f["e"]),
                        "cin": cin if r == 0 else cout, "cout": cout,
                        "se": max(1, int((cin if r == 0 else cout) * float(f["se"])))})
    return out


def tap_channels(spec: DSpec) -> dict[int, int]:
    last = {b["group"]: b["cout"] for b in blocks(spec)}
    return {lv: last[g] for lv, g in TAP_GROUPS.items()}


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """TF's SAME padding: the output is ceil(n / s), the odd pixel low-side
    short."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


class Net:
    """One forward over the weights ``w`` (parameters and running
    statistics); in train mode each BatchNorm normalizes with the batch's
    statistics and the moved running statistics land in ``stats``."""

    def __init__(self, spec: DSpec, w: dict, train: bool):
        self.spec, self.w, self.train, self.stats = spec, w, train, {}

    def conv(self, name: str, x, stride: int = 1, groups: int = 1):
        weight = self.w[f"{name}.weight"]
        k = weight.shape[-1]
        return F.conv2d(same_pad(x, k, stride), weight, self.w.get(f"{name}.bias"), stride,
                        groups=groups)

    def bn(self, name: str, x):
        if self.train:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            for key, batch in (("running_mean", mean), ("running_var", var)):
                old = self.w[f"{name}.{key}"]
                self.stats[f"{name}.{key}"] = BN_MOMENTUM * old + (1 - BN_MOMENTUM) * batch.detach()
        else:
            mean, var = self.w[f"{name}.running_mean"], self.w[f"{name}.running_var"]
        c = lambda t: t[None, :, None, None]  # noqa: E731
        mul = torch.rsqrt(var + BN_EPS) * self.w[f"{name}.weight"]
        return (x - c(mean)) * c(mul) + c(self.w[f"{name}.bias"])

    def sep_conv(self, name: str, x):
        return self.conv(f"{name}.pointwise", self.conv(f"{name}.depthwise", x,
                                                        groups=x.shape[1]))

    # -- backbone: EfficientNet-B -------------------------------------------------
    def mbconv(self, p: str, b: dict, x):
        inputs = x
        if b["expand"] != 1:
            x = swish(self.bn(f"{p}.expand_bn.bn", self.conv(f"{p}.expand", x)))
        x = swish(self.bn(f"{p}.depthwise_bn.bn", self.conv(f"{p}.depthwise", x, b["stride"],
                                                             groups=x.shape[1])))
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.conv(f"{p}.se.expand", swish(self.conv(f"{p}.se.reduce", s)))
        x = x * torch.sigmoid(s)
        x = self.bn(f"{p}.project_bn.bn", self.conv(f"{p}.project", x))
        if b["stride"] == 1 and b["cin"] == b["cout"]:
            x = x + inputs
        return x

    def backbone(self, images):
        x = swish(self.bn("backbone.stem_bn.bn", self.conv("backbone.stem", images, 2)))
        feats, bl = {}, blocks(self.spec)
        for i, b in enumerate(bl):
            x = self.mbconv(f"backbone.{b['name']}", b, x)
            if i + 1 == len(bl) or bl[i + 1]["group"] != b["group"]:
                for lv, g in TAP_GROUPS.items():
                    if g == b["group"]:
                        feats[lv] = x
        return feats

    # -- BiFPN --------------------------------------------------------------------
    def lateral(self, name: str, x):
        if x.shape[1] == self.spec.fpn_channels:
            return x
        return self.bn(f"{name}.bn", self.conv(f"{name}.Conv_0", x))

    @staticmethod
    def down(x):
        return F.max_pool2d(same_pad(x, 3, 2, float("-inf")), 3, 2)

    @staticmethod
    def up(x, like):
        return F.interpolate(x, size=like.shape[2:], mode="nearest")

    def node(self, name: str, inputs: list):
        if self.spec.fusion == "sum":
            x = sum(inputs)
        else:
            w = F.relu(self.w[f"{name}.edge_weight"])
            w = w / (w.sum() + FUSION_EPS)
            x = sum(inputs[i] * w[i] for i in range(len(inputs)))
        x = self.sep_conv(f"{name}.conv", swish(x))
        return self.bn(f"{name}.conv.bn", x)

    def fpn(self, c: dict):
        p = {lv: self.lateral(f"fpn.lateral_p{lv}", c[lv]) for lv in (3, 4, 5)}
        p[6] = self.down(self.lateral("fpn.lateral_p6", c[5]))
        top = self.spec.max_level
        for lv in range(7, top + 1):
            p[lv] = self.down(p[lv - 1])
        for r in range(self.spec.fpn_repeats):
            cell, td = f"fpn.cell{r}", {top: p[top]}
            for lv in range(top - 1, 2, -1):
                td[lv] = self.node(f"{cell}.td_p{lv}", [p[lv], self.up(td[lv + 1], p[lv])])
            out = {3: td[3]}
            for lv in range(4, top + 1):
                ins = [p[lv], self.down(out[lv - 1])] if lv == top else [
                    p[lv], td[lv], self.down(out[lv - 1])]
                out[lv] = self.node(f"{cell}.bu_p{lv}", ins)
            p = out
        return p

    # -- heads --------------------------------------------------------------------
    def head(self, name: str, feats: dict, per_anchor: int):
        parts = []
        for lv in self.spec.levels:
            x = feats[lv]
            for i in range(self.spec.head_repeats):
                x = swish(self.bn(f"{name}.bn{i}_p{lv}", self.sep_conv(f"{name}.conv{i}", x)))
            x = self.sep_conv(f"{name}.final", x).permute(0, 2, 3, 1)
            parts.append(x.reshape(x.shape[0], -1, per_anchor))
        return torch.cat(parts, dim=1)

    def __call__(self, images):
        feats = self.fpn(self.backbone(images))
        return self.head("box_net", feats, 4), self.head("class_net", feats,
                                                         self.spec.num_classes)


def forward(spec: DSpec, w: dict, images: torch.Tensor, train: bool = False):
    """``images`` (B, 3, S, S) normalized -> (deltas (B, N, 4), logits (B,
    N, C), the moved running statistics (train mode; else empty))."""
    net = Net(spec, w, train)
    deltas, logits = net(images)
    return deltas, logits, net.stats


def se_gate(x: torch.Tensor, w: dict, prefix: str) -> torch.Tensor:
    """The squeeze-excite gate of the block ``prefix`` on ``x``."""
    net = Net(None, w, False)
    s = net.conv(f"{prefix}.se.expand", swish(net.conv(f"{prefix}.se.reduce",
                                                        x.mean(dim=(2, 3), keepdim=True))))
    return x * torch.sigmoid(s)


def fast_fusion(inputs: list, edge_weight: torch.Tensor) -> torch.Tensor:
    """``sum_i relu(w_i) x_i / (sum_j relu(w_j) + 1e-4)``."""
    w = F.relu(edge_weight)
    w = w / (w.sum() + FUSION_EPS)
    return sum(x * w[i] for i, x in enumerate(inputs))


def anchors(spec: DSpec, device) -> torch.Tensor:
    cfg = AnchorConfig(input_size=spec.input_size, anchor_scale=spec.anchor_scale,
                       max_level=spec.max_level)
    return torch.from_numpy(generate_anchors(cfg)).to(device)


def _decayed(key: str, value: torch.Tensor) -> bool:
    return key.endswith(".weight") and value.ndim == 4


class Trainer:
    """The whole-model train step from a state dict ``state`` (parameters
    named in ``param_keys``, the rest running statistics), in the state's
    dtype: loss, gradient, clipping, decay, momentum, the schedule's
    learning rate and the EMA."""

    def __init__(self, spec: DSpec, state: dict, param_keys, base_lr: float, total_steps: int,
                 warmup_steps: int):
        self.spec = spec
        self.params = {k: state[k].detach().clone() for k in param_keys}
        self.stats = {k: v.detach().clone() for k, v in state.items() if k not in self.params}
        self.trace = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.ema = {k: v.clone() for k, v in self.params.items()}
        self.count = 0
        self.schedule = warmup_cosine_decay_schedule(base_lr, max(warmup_steps, 1),
                                                     max(total_steps, 2))
        self.anchors = anchors(spec, next(iter(self.params.values())).device)

    def step(self, images, boxes, valid) -> dict:
        """One step on a normalized batch: the loss, the gradient as the
        optimizer took it (clipped, decayed) and the raw gradient."""
        box_t, cls_t, pos, ign = assign_targets(self.anchors, boxes, valid, self.spec.num_classes)
        params = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        with tf32_off():
            deltas, logits, stats = forward(self.spec, {**params, **self.stats}, images, True)
            total, _ = detection_loss(deltas, logits, box_t, cls_t, pos, ign)
            keys = list(params)
            grads = torch.autograd.grad(total, [params[k] for k in keys])
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = MAX_GRAD_NORM / norm if norm >= MAX_GRAD_NORM else 1.0
        g = {k: gr * scale for k, gr in zip(keys, grads)}
        for k in keys:
            if _decayed(k, self.params[k]):
                g[k] = g[k] + WEIGHT_DECAY * self.params[k]
        lr = self.schedule(self.count)
        self.trace = {k: g[k] + MOMENTUM * self.trace[k] for k in keys}
        new = {k: self.params[k] - lr * self.trace[k] for k in keys}
        t = np.float32(self.count)
        decay = float(np.minimum(np.float32(0.9998), (np.float32(1) + t) / (np.float32(10) + t)))
        keep = float(np.float32(1) - np.float32(decay))
        self.ema = {k: self.ema[k] * decay + new[k] * keep for k in keys}
        self.params, self.stats = new, {**self.stats, **stats}
        self.count += 1
        return {"loss": float(total.detach()), "opt_grad": {k: v.detach() for k, v in g.items()},
                "grad": dict(zip(keys, (x.detach() for x in grads)))}
