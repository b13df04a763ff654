"""EfficientDet-D7x's forward in plain float32 torch, for the benchmark.

A frozen copy of the model part of the repo's test reference
(``tests/plain/effdet.py``), written from the published description
(arXiv:1911.09070; google/automl ``efficientdet/hparams_config.py``, entry
``efficientdet-d7x``, ``efficientdet_arch.py``,
``efficientnet/efficientnet_builder.py``) and not from the program: the
B-series backbone with squeeze-excite and swish (B7: width 2.0, depth 3.1),
the BiFPN over levels 3..8 (P8 one more max pool of P7) with automl's
``sum`` fusion (``add_n``: no fusion weights), the heads. The weights are
one flat dict under the names a checkpoint's leaves take once read
(:func:`benchmark.reference.effdet_d7x.step.load_checkpoint`);
:func:`parameter_shapes` lists them. Departures from automl, where the
program's D family shares a design with its lite family: one lateral 1x1
convolution and BatchNorm a level (automl: one an edge of the first cell);
no drop-connect; flax's BatchNorm (``(x - mean) * (rsqrt(var + eps) *
scale) + bias``, the fast biased batch variance, running statistics ``r <-
0.99 r + 0.01 batch``).

One departure from the test reference, for memory alone: with
``recompute`` (the benchmark's train step at 1536 px does not fit the card
otherwise), each MBConv block, each BiFPN cell and each head's chain at a
level runs under ``torch.utils.checkpoint`` (non-reentrant), which keeps
its inputs and computes it again in the backward. The arithmetic is the
same; the running statistics are taken from the first pass alone (a
recomputation leaves them as they are).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-3
BN_MOMENTUM = 0.99
FUSION_EPS = 1e-4
ANCHORS_PER_CELL = 9
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


D_SPECS = {"efficientdet_d7x": DSpec(2.0, 3.1, 1536, 384, 8, 5, fusion="sum", max_level=8)}


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


def parameter_shapes(spec: DSpec) -> dict[str, tuple[str, tuple[int, ...]]]:
    """Every weight the forward reads: name -> (kind, shape), the kind one of
    ``conv`` (an OIHW kernel), ``bias``, ``scale``, ``shift`` (BatchNorm's
    weight and bias), ``mean``, ``var`` (its running statistics) and
    ``edge`` (a fusion weight), in the forward's order."""
    out: dict = {}

    def conv(name, cin, cout, k, groups=1, bias=False):
        out[f"{name}.weight"] = ("conv", (cout, cin // groups, k, k))
        if bias:
            out[f"{name}.bias"] = ("bias", (cout,))

    def bn(name, c):
        for leaf, kind in (("weight", "scale"), ("bias", "shift"), ("running_mean", "mean"),
                           ("running_var", "var")):
            out[f"{name}.{leaf}"] = (kind, (c,))

    def sep(name, cin, cout):
        conv(f"{name}.depthwise", cin, cin, 3, groups=cin)
        conv(f"{name}.pointwise", cin, cout, 1, bias=True)

    stem = round_filters(32, spec.width)
    conv("backbone.stem", 3, stem, 3)
    bn("backbone.stem_bn.bn", stem)
    for b in blocks(spec):
        p, mid = f"backbone.{b['name']}", b["cin"] * b["expand"]
        if b["expand"] != 1:
            conv(f"{p}.expand", b["cin"], mid, 1)
            bn(f"{p}.expand_bn.bn", mid)
        conv(f"{p}.depthwise", mid, mid, b["kernel"], groups=mid)
        bn(f"{p}.depthwise_bn.bn", mid)
        conv(f"{p}.se.reduce", mid, b["se"], 1, bias=True)
        conv(f"{p}.se.expand", b["se"], mid, 1, bias=True)
        conv(f"{p}.project", mid, b["cout"], 1)
        bn(f"{p}.project_bn.bn", b["cout"])
    ch, taps = spec.fpn_channels, tap_channels(spec)
    for lv, cin in ((3, taps[3]), (4, taps[4]), (5, taps[5]), (6, taps[5])):
        if cin != ch:
            conv(f"fpn.lateral_p{lv}.Conv_0", cin, ch, 1, bias=True)
            bn(f"fpn.lateral_p{lv}.bn", ch)
    top = spec.max_level
    for r in range(spec.fpn_repeats):
        nodes = [(f"td_p{lv}", 2) for lv in range(top - 1, 2, -1)]
        nodes += [(f"bu_p{lv}", 2 if lv == top else 3) for lv in range(4, top + 1)]
        for node, n_in in nodes:
            name = f"fpn.cell{r}.{node}"
            if spec.fusion != "sum":
                out[f"{name}.edge_weight"] = ("edge", (n_in,))
            sep(f"{name}.conv", ch, ch)
            bn(f"{name}.conv.bn", ch)
    for head, per_anchor in (("box_net", 4), ("class_net", spec.num_classes)):
        for i in range(spec.head_repeats):
            sep(f"{head}.conv{i}", ch, ch)
            for lv in spec.levels:
                bn(f"{head}.bn{i}_p{lv}", ch)
        sep(f"{head}.final", ch, per_anchor * ANCHORS_PER_CELL)
    return out


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
    statistics and the moved running statistics land in ``stats``, from
    the first pass (module docstring: ``recompute``)."""

    def __init__(self, spec: DSpec, w: dict, train: bool, recompute: bool = False):
        self.spec, self.w, self.train, self.stats = spec, w, train, {}
        self.recompute = recompute

    def run(self, fn, *args):
        """``fn(*args)``, under a non-reentrant checkpoint with ``recompute``
        while a gradient is taken."""
        if self.recompute and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

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
                if f"{name}.{key}" not in self.stats:  # a recomputation leaves them
                    old = self.w[f"{name}.{key}"]
                    self.stats[f"{name}.{key}"] = (BN_MOMENTUM * old
                                                   + (1 - BN_MOMENTUM) * batch.detach())
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
            x = self.run(self.mbconv, f"backbone.{b['name']}", b, x)
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

    def cell(self, cell: str, *feats):
        """One BiFPN cell over the levels' maps, bottom level first."""
        top = self.spec.max_level
        p = dict(zip(self.spec.levels, feats))
        td = {top: p[top]}
        for lv in range(top - 1, 2, -1):
            td[lv] = self.node(f"{cell}.td_p{lv}", [p[lv], self.up(td[lv + 1], p[lv])])
        out = {3: td[3]}
        for lv in range(4, top + 1):
            ins = [p[lv], self.down(out[lv - 1])] if lv == top else [
                p[lv], td[lv], self.down(out[lv - 1])]
            out[lv] = self.node(f"{cell}.bu_p{lv}", ins)
        return tuple(out[lv] for lv in self.spec.levels)

    def fpn(self, c: dict):
        p = {lv: self.lateral(f"fpn.lateral_p{lv}", c[lv]) for lv in (3, 4, 5)}
        p[6] = self.down(self.lateral("fpn.lateral_p6", c[5]))
        for lv in range(7, self.spec.max_level + 1):
            p[lv] = self.down(p[lv - 1])
        feats = tuple(p[lv] for lv in self.spec.levels)
        for r in range(self.spec.fpn_repeats):
            feats = self.run(self.cell, f"fpn.cell{r}", *feats)
        return dict(zip(self.spec.levels, feats))

    # -- heads --------------------------------------------------------------------
    def head_level(self, name: str, lv: int, x):
        for i in range(self.spec.head_repeats):
            x = swish(self.bn(f"{name}.bn{i}_p{lv}", self.sep_conv(f"{name}.conv{i}", x)))
        return self.sep_conv(f"{name}.final", x)

    def head(self, name: str, feats: dict, per_anchor: int):
        parts = []
        for lv in self.spec.levels:
            x = self.run(self.head_level, name, lv, feats[lv]).permute(0, 2, 3, 1)
            parts.append(x.reshape(x.shape[0], -1, per_anchor))
        return torch.cat(parts, dim=1)

    def __call__(self, images):
        feats = self.fpn(self.backbone(images))
        return self.head("box_net", feats, 4), self.head("class_net", feats,
                                                         self.spec.num_classes)


def forward(spec: DSpec, w: dict, images: torch.Tensor, train: bool = False,
            recompute: bool = False):
    """``images`` (B, 3, S, S) normalized -> (deltas (B, N, 4), logits (B,
    N, C), the moved running statistics (train mode; else empty))."""
    net = Net(spec, w, train, recompute)
    deltas, logits = net(images)
    return deltas, logits, net.stats
