"""EfficientDet-D3 in the port (``models/``: the B-series backbone with
squeeze-excite and swish, the BiFPN's fast normalized fusion) against the
plain float32 reference written from the published description
(``tests/plain/effdet.py``), on the CPU.

- Seeded random weights at a small D spec (the B3 backbone at 128 px,
  BiFPN 16 x 2, heads 2; running statistics and fusion weights moved off
  their init): the forward in eval mode, float32, to 1e-5 of the output's
  largest magnitude (the two sum convolutions and BatchNorm in another
  order: 2e-7 measured); in train mode, float64, to 1e-5 relative
  (train-mode BatchNorm over a batch of 2 at the 1x1 to 4x4 maps of levels
  5 to 7 amplifies float32 round-off about 300x, 6e-5 measured, so the
  check of the arithmetic's structure runs where round-off is 1e-16:
  1e-13 measured).
- One train step (float64, the same reason): the loss, the first gradient
  as the optimizer took it and the BatchNorm statistics after it, to 1e-8
  relative (1e-12 measured; the targets and losses are the same arithmetic
  in both, the sums in another order).
- A fusion weight below 0 gives its input no share; squeeze-excite's gate;
  a D3 checkpoint through save and load, bit for bit.
- D3 at published widths, built with no forward: the taps 48, 136, 384, the
  repeats 2, 3, 3, 5, 5, 6, 2 and the stem 40, as the reference derives
  them from automl's block strings; 11.95 M parameters at 90 classes, within
  2% of the published 12.0 M (the port resamples once a level where automl
  resamples once an edge, 0.08 M fewer).
- ``analytic_flops`` counts squeeze-excite's convolutions: equal to
  ``FlopCounterMode``'s count of the D3 forward at 128 px.
- ``efficientdet_d3`` resolves as a spec name, a checkpoint and a ``.tflite``
  sibling path (the serving CLIs' ``--model``) and as the train CLI's
  ``--architecture``; the turbo lane (lite blocks only) refuses it.
- The lite0 model is the one it was: the shipped checkpoint's names, 3,163,373
  parameters, no ``se`` or fusion weight, ReLU6 and plain sums.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

from plain import effdet as plain  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from vbt_tpu_torch.models import EfficientDet, ModelSpec, get_model_spec  # noqa: E402
from vbt_tpu_torch.models.bifpn import FastFuseNode, FuseNode  # noqa: E402
from vbt_tpu_torch.models.efficientdet import init_parameters  # noqa: E402
from vbt_tpu_torch.models.efficientnet_lite import (MBConvSEBlock, scaled_blocks,  # noqa: E402
                                                    stem_channels, tap_channels)
from vbt_tpu_torch.runtime import checkpoint as ck  # noqa: E402
from vbt_tpu_torch.runtime.pipeline import resolve_model  # noqa: E402
from vbt_tpu_torch.tools import roofline  # noqa: E402
from vbt_tpu_torch.train.train_step import Trainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ModelSpec("small_d", "b3", 128, 16, 2, 2, anchor_scale=4.0, act="swish",
                  fusion="fastattn")
SMALL_PLAIN = plain.DSpec(1.2, 1.4, 128, 16, 2, 2)
EVAL_TOL = 1e-5  # of the output's largest magnitude, float32 (2e-7 measured)
F64_TOL = 1e-5  # relative, float64 forward (1e-13 measured)
STEP_TOL = 1e-8  # relative, float64 step (1e-12 measured)


def _model(dtype=torch.float32) -> EfficientDet:
    """The small D model, seeded, with running statistics and fusion
    weights (some below 0) moved off their init."""
    model = init_parameters(EfficientDet(SMALL), torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("running_mean"):
                v.copy_(0.1 * torch.randn(v.shape, generator=gen))
            elif k.endswith("running_var"):
                v.copy_(0.5 + torch.rand(v.shape, generator=gen))
            elif k.endswith("edge_weight"):
                v.copy_(2 * torch.rand(v.shape, generator=gen) - 0.3)
    return model.to(dtype)


def _images(b, dtype=torch.float32):
    return torch.randn(b, 3, 128, 128, generator=torch.Generator().manual_seed(3)).to(dtype)


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
        assert g.shape == w.shape == (2, 3069, w.shape[-1]) and g.dtype == dtype
        if train:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=F64_TOL, atol=0)
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=EVAL_TOL * float(w.abs().max()))
    if train:  # the port moved its running statistics in place, as the reference
        moved = model.state_dict()
        assert stats.keys() == {k for k in moved if "running" in k}
        for k, v in stats.items():
            np.testing.assert_allclose(moved[k].numpy(), v.numpy(), rtol=F64_TOL, atol=0)


def _batch(b, dtype):
    rng = np.random.default_rng(4)
    boxes = np.zeros((b, 3, 4), np.float32)
    valid = np.zeros((b, 3), bool)
    for i in range(b):
        y0, x0 = rng.uniform(8, 60, 2)
        h, w = rng.uniform(20, 60, 2)
        boxes[i, 0] = [y0, x0, y0 + h, x0 + w]
        valid[i, 0] = True
    return {"images": _images(b, dtype), "gt_boxes": torch.from_numpy(boxes),
            "gt_valid": torch.from_numpy(valid)}


def test_a_train_step_equals_the_plain_reference():
    sd = _model(torch.float64).state_dict()
    hp = dict(base_lr=0.01, total_steps=100, warmup_steps=5)
    trainer = Trainer(SMALL, dtype=torch.float64, device="cpu", **hp)
    state, metrics = trainer.train_step(trainer.state_from(sd), _batch(2, torch.float64))
    ref = plain.Trainer(SMALL_PLAIN, sd, trainer.param_keys, **hp)
    out = ref.step(*_batch(2, torch.float64).values())
    assert float(metrics["loss"]) == pytest.approx(out["loss"], rel=STEP_TOL)
    grad = state.opt_state.trace  # from a zero trace: the clipped, decayed gradient
    assert grad.keys() == out["opt_grad"].keys()
    assert any(k.endswith("edge_weight") for k in grad) and any(".se." in k for k in grad)
    # A leaf whose gradient is 0 (a bias right before a train-mode BatchNorm)
    # reads round-off: each leaf's floor is the median leaf's largest entry.
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


def test_a_negative_fusion_weight_gives_its_input_no_share():
    node = init_parameters(EfficientDet(SMALL), torch.Generator().manual_seed(5)).fpn.cell0.bu_p4
    assert isinstance(node, FastFuseNode) and node.edge_weight.shape == (3,)
    with torch.no_grad():
        node.edge_weight.copy_(torch.tensor([-0.5, 2.0, 1.0]))
    node.eval()
    gen = torch.Generator().manual_seed(6)
    ins = [torch.randn(2, 16, 8, 8, generator=gen) for _ in range(3)]
    other = [torch.randn(2, 16, 8, 8, generator=gen)] + ins[1:]
    with torch.no_grad():
        a, b = node(ins), node(other)
    assert torch.equal(a, b)  # the first input moved, nothing else did
    fused = plain.fast_fusion(ins, node.edge_weight.detach())
    np.testing.assert_allclose(fused.numpy(), ((2 * ins[1] + ins[2]) / (3 + 1e-4)).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_the_se_gate_equals_the_reference():
    model = _model()
    block = model.backbone.g1_b1
    assert isinstance(block, MBConvSEBlock) and block.se.reduce.weight.shape[0] == 8
    x = torch.randn(2, 192, 16, 16, generator=torch.Generator().manual_seed(7))
    sd = {k: v for k, v in model.state_dict().items()}
    with torch.no_grad():
        got = block.se(x)
    want = plain.se_gate(x, sd, "backbone.g1_b1")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)


def test_a_d3_checkpoint_round_trips(tmp_path):
    model = init_parameters(EfficientDet(get_model_spec("efficientdet_d3")),
                            torch.Generator().manual_seed(8))
    sd = model.state_dict()
    path = str(tmp_path / "efficientdet_d3.msgpack")
    ck.save_params(path, sd)
    got = ck.load_checkpoint(path)
    assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)
    assert "fpn.cell5.bu_p7.edge_weight" in got and "backbone.g6_b1.se.expand.bias" in got
    tree = ck.msgpack_restore(open(path, "rb").read())
    assert tree["params"]["fpn"]["cell0"]["bu_p4"]["edge_weight"].shape == (3,)
    assert ck.msgpack_pack(ck.to_flax_variables(got)) == open(path, "rb").read()
    ck.load_into(EfficientDet(get_model_spec("efficientdet_d3")), got)
    spec, found = resolve_model(path)
    assert spec.name == "efficientdet_d3" and found == path


def test_d3_at_published_widths():
    spec = get_model_spec("efficientdet_d3")
    assert (spec.input_size, spec.fpn_channels, spec.fpn_repeats, spec.head_repeats,
            spec.anchor_scale, spec.act, spec.fusion) == (896, 160, 6, 4, 4.0, "swish",
                                                          "fastattn")
    assert tap_channels("b3") == {3: 48, 4: 136, 5: 384} == plain.tap_channels(plain.D_SPECS[
        "efficientdet_d3"])
    assert [g.repeats for g in scaled_blocks("b3")] == [2, 3, 3, 5, 5, 6, 2]
    assert stem_channels("b3") == 40
    model = EfficientDet(ModelSpec("d3_coco", "b3", 896, 160, 6, 4, anchor_scale=4.0,
                                   num_classes=90, act="swish", fusion="fastattn"))
    blocks = [getattr(model.backbone, name) for _, name in model.backbone.block_names]
    ref = plain.blocks(plain.D_SPECS["efficientdet_d3"])
    assert [(b.se.reduce.weight.shape[0], b.project.weight.shape[0]) for b in blocks] == [
        (r["se"], r["cout"]) for r in ref]
    n = sum(p.numel() for p in model.parameters())
    assert n == pytest.approx(12.0e6, rel=0.02), n


def test_analytic_flops_count_squeeze_excite():
    model = EfficientDet(get_model_spec("efficientdet_d3")).eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.zeros(1, 3, 128, 128))
    by_module = {k: sum(v.values()) for k, v in counter.get_flop_counts().items()}
    want = roofline.analytic_flops(1, 128, "efficientdet_d3")
    assert sum(want.values()) == counter.get_total_flops()
    assert want["backbone"] == by_module["EfficientDet.backbone"]
    assert want["bifpn"] == by_module["EfficientDet.fpn"]
    assert sum(roofline.analytic_flops(1, 896, "efficientdet_d3").values()) == 44_621_839_808


def test_lite0_is_the_model_it_was():
    model = EfficientDet(get_model_spec("efficientdet_lite0"))
    shipped = ck.load_checkpoint(os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack"))
    assert list(model.state_dict()) == [k for k in model.state_dict() if k in shipped]
    assert model.state_dict().keys() == shipped.keys()
    assert sum(p.numel() for p in model.parameters()) == 3_163_373
    names = [n for n, _ in model.named_modules()]
    assert not any(n.endswith(".se") for n in names)
    assert all(type(m) is FuseNode for m in model.modules() if isinstance(m, FuseNode))
    assert model.backbone.g1_b0.expand_bn.act is torch.nn.functional.relu6
    assert model.box_net.act is torch.nn.functional.relu6


def test_every_cli_resolves_the_d3_name():
    from vbt_tpu_torch.cli import train as train_cli

    ctx = train_cli.make_command().make_context("train", ["--architecture", "efficientdet_d3"])
    assert ctx.params["architecture"] == "efficientdet_d3"
    for arg in ("efficientdet_d3", "d3", "models/efficientdet_d3.msgpack",
                "models/efficientdet_d3.tflite"):
        assert resolve_model(arg)[0] is get_model_spec("efficientdet_d3")
    assert resolve_model(os.path.join(REPO, "models", "efficientdet_d3.tflite"))[1] == os.path.join(
        REPO, "models", "efficientdet_d3.msgpack")


def test_the_turbo_backbone_refuses_the_d_family():
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline

    with pytest.raises(ValueError, match="lite family"):
        DetectionPipeline(SMALL, _model().state_dict(), device="cpu", backbone="turbo")
