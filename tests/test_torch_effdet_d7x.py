"""EfficientDet-D7x in the port (``models/``: the B7 backbone, a BiFPN over
P3-P8 with sum fusion under swish, heads over six levels) against the plain
float32 reference written from the published description
(``tests/plain/effdet.py``), on the CPU.

- Seeded random weights at a small six-level, sum-fusion D spec (the B0
  backbone at 256 px, so P8 is 1 x 1; BiFPN 16 x 2, heads 2; running
  statistics moved off their init): the forward in eval mode, float32, to
  1e-5 of the output's largest magnitude; in train mode, float64, to 1e-5
  relative (train-mode BatchNorm over a batch of 2 at the 1x1 to 4x4 maps
  of levels 6 to 8 amplifies float32 round-off, as in D3's tests).
- One train step (float64): the loss, the first gradient as the optimizer
  took it, the BatchNorm statistics and the parameters after it, to 1e-8
  relative.
- The levels belong to the built module: ``td_p7`` and ``bu_p8`` in every
  cell, ``bn{i}_p8`` in the heads, no fusion weight, P3-P8 maps out of the
  BiFPN and as many output rows as the six-level anchors; a six-level
  checkpoint through save and load, bit for bit, with its ``p8`` names.
- D7x at published widths, built with no forward: the stem 64, the taps
  80, 224, 640, the repeats 4, 7, 7, 10, 10, 13, 4 as the reference derives
  them from automl's block strings, 76.81 M parameters at 90 classes (Table
  1: 77 M), 442,260 anchors at 1536.
- ``analytic_flops`` counts the sixth level: equal to ``FlopCounterMode``'s
  count of the D7x forward at 128 px; at 1536 it is the benchmark's
  ``counts/flops_d7x.py`` count, pinned.
- ``efficientdet_d7x`` resolves as a spec name, a checkpoint and a
  ``.tflite`` sibling path (the serving CLIs' ``--model``) and as the train
  CLI's ``--architecture``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

from plain import effdet as plain  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from vbt_tpu_torch.models import EfficientDet, ModelSpec, get_model_spec  # noqa: E402
from vbt_tpu_torch.models.anchors import generate_anchors, num_anchors  # noqa: E402
from vbt_tpu_torch.models.bifpn import FastFuseNode  # noqa: E402
from vbt_tpu_torch.models.efficientdet import init_parameters  # noqa: E402
from vbt_tpu_torch.models.efficientnet_lite import (scaled_blocks, stem_channels,  # noqa: E402
                                                    tap_channels)
from vbt_tpu_torch.runtime import checkpoint as ck  # noqa: E402
from vbt_tpu_torch.runtime.pipeline import resolve_model  # noqa: E402
from vbt_tpu_torch.tools import roofline  # noqa: E402
from vbt_tpu_torch.train.train_step import Trainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 256
SMALL = ModelSpec("small_d7x", "b0", SIZE, 16, 2, 2, anchor_scale=4.0, act="swish",
                  fusion="sum", max_level=8)
SMALL_PLAIN = plain.DSpec(1.0, 1.0, SIZE, 16, 2, 2, fusion="sum", max_level=8)
EVAL_TOL = 1e-5  # of the output's largest magnitude, float32
F64_TOL = 1e-5  # relative, float64 forward
STEP_TOL = 1e-8  # relative, float64 step
ROWS = 9 * (32 ** 2 + 16 ** 2 + 8 ** 2 + 4 ** 2 + 2 ** 2 + 1)  # six levels at 256 px


def _model(dtype=torch.float32) -> EfficientDet:
    """The small six-level model, seeded, with running statistics moved off
    their init."""
    model = init_parameters(EfficientDet(SMALL), torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("running_mean"):
                v.copy_(0.1 * torch.randn(v.shape, generator=gen))
            elif k.endswith("running_var"):
                v.copy_(0.5 + torch.rand(v.shape, generator=gen))
    return model.to(dtype)


def _images(b, dtype=torch.float32):
    return torch.randn(b, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(3)).to(dtype)


@pytest.mark.parametrize("train,dtype", [(False, torch.float32), (True, torch.float64)],
                         ids=["eval-f32", "train-f64"])
def test_forward_equals_the_plain_reference(train, dtype):
    model = _model(dtype).train(train)
    x = _images(2, dtype)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        got = model(x)
        want_d, want_l, stats = plain.forward(SMALL_PLAIN, state, x, train)
    for g, w in zip(got, (want_d, want_l)):
        assert g.shape == w.shape == (2, ROWS, w.shape[-1]) and g.dtype == dtype
        if train:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=F64_TOL, atol=0)
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=EVAL_TOL * float(w.abs().max()))
    if train:  # the port moved its running statistics in place, as the reference
        moved = model.state_dict()
        assert stats.keys() == {k for k in moved if "running" in k}
        assert "box_net.bn1_p8.running_mean" in stats
        for k, v in stats.items():
            np.testing.assert_allclose(moved[k].numpy(), v.numpy(), rtol=F64_TOL, atol=0)


def _batch(b, dtype):
    rng = np.random.default_rng(4)
    boxes = np.zeros((b, 3, 4), np.float32)
    valid = np.zeros((b, 3), bool)
    for i in range(b):
        y0, x0 = rng.uniform(8, 120, 2)
        h, w = rng.uniform(30, 120, 2)
        boxes[i, 0] = [y0, x0, y0 + h, x0 + w]
        valid[i, 0] = True
    return {"images": _images(b, dtype), "gt_boxes": torch.from_numpy(boxes),
            "gt_valid": torch.from_numpy(valid)}


def test_a_train_step_equals_the_plain_reference():
    sd = _model(torch.float64).state_dict()
    hp = dict(base_lr=0.01, total_steps=100, warmup_steps=5)
    trainer = Trainer(SMALL, dtype=torch.float64, device="cpu", **hp)
    assert trainer.anchors.shape == (ROWS, 4)
    state, metrics = trainer.train_step(trainer.state_from(sd), _batch(2, torch.float64))
    ref = plain.Trainer(SMALL_PLAIN, sd, trainer.param_keys, **hp)
    out = ref.step(*_batch(2, torch.float64).values())
    assert float(metrics["loss"]) == pytest.approx(out["loss"], rel=STEP_TOL)
    grad = state.opt_state.trace  # from a zero trace: the clipped, decayed gradient
    assert grad.keys() == out["opt_grad"].keys()
    assert not any(k.endswith("edge_weight") for k in grad)
    assert "fpn.cell1.bu_p8.conv.bn.bias" in grad
    floor = float(np.median([float(v.abs().max()) for v in out["opt_grad"].values()]))
    for k, v in out["opt_grad"].items():
        np.testing.assert_allclose(grad[k].numpy(), v.numpy(), rtol=STEP_TOL,
                                   atol=STEP_TOL * floor, err_msg=k)
    assert state.batch_stats.keys() == ref.stats.keys()
    for k, v in ref.stats.items():
        np.testing.assert_allclose(state.batch_stats[k].numpy(), v.numpy(), rtol=STEP_TOL,
                                   atol=0, err_msg=k)
    for k, v in ref.params.items():
        np.testing.assert_allclose(state.params[k].numpy(), v.numpy(), rtol=STEP_TOL,
                                   atol=STEP_TOL * float(v.abs().max()), err_msg=k)


def test_the_levels_belong_to_the_built_module():
    model = _model().eval()
    assert model.fpn.levels == (3, 4, 5, 6, 7, 8)
    names = {n for n, _ in model.named_modules()}
    for r in range(2):
        assert {f"fpn.cell{r}.td_p{lv}" for lv in range(3, 8)} <= names
        assert {f"fpn.cell{r}.bu_p{lv}" for lv in range(4, 9)} <= names
        assert f"fpn.cell{r}.td_p8" not in names and f"fpn.cell{r}.bu_p3" not in names
    assert {f"box_net.bn{i}_p8" for i in range(2)} <= names
    assert not any(isinstance(m, FastFuseNode) for m in model.modules())
    with torch.no_grad():
        feats = model.fpn(model.backbone(_images(1)))
    assert {lv: tuple(f.shape[2:]) for lv, f in feats.items()} == {
        lv: (SIZE >> lv,) * 2 for lv in range(3, 9)}
    assert num_anchors(SMALL.anchor_config) == ROWS
    for name in ("efficientdet_lite0", "efficientdet_d3"):
        five = EfficientDet(get_model_spec(name))
        assert five.fpn.levels == (3, 4, 5, 6, 7) and get_model_spec(name).max_level == 7
        assert not any("p8" in n for n, _ in five.named_modules())


def test_a_six_level_checkpoint_round_trips(tmp_path):
    sd = _model().state_dict()
    path = str(tmp_path / "small_d7x.msgpack")
    ck.save_params(path, sd)
    got = ck.load_checkpoint(path)
    assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)
    assert "fpn.cell1.bu_p8.conv.bn.running_var" in got and "class_net.bn1_p8.weight" in got
    tree = ck.msgpack_restore(open(path, "rb").read())
    assert tree["batch_stats"]["box_net"]["bn0_p8"]["var"].shape == (16,)
    assert tree["params"]["fpn"]["cell0"]["bu_p8"]["conv"]["BatchNorm_0"]["scale"].shape == (16,)
    assert ck.msgpack_pack(ck.to_flax_variables(got)) == open(path, "rb").read()
    ck.load_into(EfficientDet(SMALL), got)


def test_d7x_at_published_widths():
    spec = get_model_spec("efficientdet_d7x")
    assert (spec.backbone, spec.input_size, spec.fpn_channels, spec.fpn_repeats,
            spec.head_repeats, spec.anchor_scale, spec.act, spec.fusion, spec.max_level) == (
        "b7", 1536, 384, 8, 5, 4.0, "swish", "sum", 8)
    assert stem_channels("b7") == 64
    assert tap_channels("b7") == {3: 80, 4: 224, 5: 640} == plain.tap_channels(
        plain.D_SPECS["efficientdet_d7x"])
    assert [g.repeats for g in scaled_blocks("b7")] == [4, 7, 7, 10, 10, 13, 4]
    coco = ModelSpec("d7x_coco", "b7", 1536, 384, 8, 5, anchor_scale=4.0, num_classes=90,
                     act="swish", fusion="sum", max_level=8)
    model = EfficientDet(coco)
    blocks = [getattr(model.backbone, name) for _, name in model.backbone.block_names]
    ref = plain.blocks(plain.D_SPECS["efficientdet_d7x"])
    assert len(blocks) == 55
    assert [(b.se.reduce.weight.shape[0], b.project.weight.shape[0]) for b in blocks] == [
        (r["se"], r["cout"]) for r in ref]
    n = sum(p.numel() for p in model.parameters())
    assert n == pytest.approx(77e6, rel=0.03), n
    assert n == 76_813_086
    assert num_anchors(spec.anchor_config) == 442_260
    anchors = generate_anchors(spec.anchor_config)
    assert anchors.shape == (442_260, 4)
    assert anchors[-9:, 0].min() == anchors[-9:, 1].min() == 1536 - 128  # P8: 6 x 6, stride 256


def test_analytic_flops_count_the_sixth_level():
    from benchmark.counts.flops_d7x import forward_flops

    model = EfficientDet(get_model_spec("efficientdet_d7x")).eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.zeros(1, 3, 128, 128))
    by_module = {k: sum(v.values()) for k, v in counter.get_flop_counts().items()}
    want = roofline.analytic_flops(1, 128, "efficientdet_d7x")
    assert sum(want.values()) == counter.get_total_flops()
    assert want["backbone"] == by_module["EfficientDet.backbone"]
    assert want["bifpn"] == by_module["EfficientDet.fpn"]
    full = sum(roofline.analytic_flops(1, 1536, "efficientdet_d7x").values())
    assert full == forward_flops("efficientdet_d7x") == 782_309_426_176


def test_every_cli_resolves_the_d7x_name():
    from vbt_tpu_torch.cli import train as train_cli

    ctx = train_cli.make_command().make_context("train", ["--architecture", "efficientdet_d7x"])
    assert ctx.params["architecture"] == "efficientdet_d7x"
    for arg in ("efficientdet_d7x", "d7x", "models/efficientdet_d7x.msgpack",
                "models/efficientdet_d7x.tflite", "efficientdet_d7x_whole"):
        assert resolve_model(arg)[0] is get_model_spec("efficientdet_d7x")
    assert resolve_model("efficientdet_d7x") == (get_model_spec("efficientdet_d7x"), None)
