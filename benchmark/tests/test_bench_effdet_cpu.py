"""The D family's train cell (``d3.train``: ``drivers/train_effdet.py``,
``reference/effdet/``, ``counts/flops_effdet.py``) through the whole
harness on the CPU, at a tiny D spec in D3's place (the B0 backbone at 64
px, BiFPN 16 x 1, one head repeat, seeded weights in a temporary
checkpoint): a sound run is correct and a traced one prints the new
per-layer metrics, as a traced ``lite0.train`` does; a step that leaves out
half its batch, or keeps its state, is not correct. D3 itself is too large
for this CPU (about 6 GB of activations an image); the card runs it."""

from __future__ import annotations

import sys

import pytest

torch = pytest.importorskip("torch")

TINY_SPEC = "efficientdet_dtiny"
NEW_METRICS = {"backbone_host_ms.train", "fpn_host_ms.train"}


@pytest.fixture
def tiny_d(monkeypatch, tmp_path):
    """``d3`` resolves to a tiny D spec and a seeded checkpoint of it."""
    from benchmark.core import registry
    from benchmark.reference.effdet import model as plain
    from vbt_tpu_torch.models import MODEL_SPECS, EfficientDet, ModelSpec
    from vbt_tpu_torch.models.efficientdet import init_parameters
    from vbt_tpu_torch.runtime.checkpoint import save_params

    spec = ModelSpec(TINY_SPEC, "b0", 64, 16, 1, 1, anchor_scale=4.0, act="swish",
                     fusion="fastattn")
    monkeypatch.setitem(MODEL_SPECS, TINY_SPEC, spec)
    monkeypatch.setitem(plain.D_SPECS, TINY_SPEC, plain.DSpec(1.0, 1.0, 64, 16, 1, 1))
    path = tmp_path / f"{TINY_SPEC}.msgpack"
    save_params(str(path), init_parameters(EfficientDet(spec),
                                           torch.Generator().manual_seed(0)).state_dict())
    real = registry.config

    def config(bench, name):
        got = real(bench, name)
        return dict(got, spec=TINY_SPEC, checkpoint=str(path)) if name == "d3" else got

    monkeypatch.setattr(registry, "config", config)
    conftest = sys.modules["benchmark.tests.conftest"]
    monkeypatch.setitem(conftest.TINY, "train_effdet", conftest.TINY["train"])


def test_a_small_d_run_is_correct(cpu_run, tiny_d):
    rc, result, err = cpu_run("d3.train")
    assert rc == 0, err
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"train_img_per_s", "setup_s"}
    assert "check late stage" in err


@pytest.mark.parametrize("workload", ["d3.train", "lite0.train"])
def test_a_traced_train_run_prints_the_model_spans(cpu_run, tiny_d, workload):
    rc, result, err = cpu_run(workload, trace=1)
    assert rc == 0, err
    assert result["correct"] is True, result["checks"]
    got = set(result["metrics"])
    assert NEW_METRICS <= got
    assert ("mfu_effdet.train" in got) == (workload == "d3.train")
    assert ("mfu.train" in got) == (workload != "d3.train")
    spans = {k: result["metrics"][k]["value"] for k in NEW_METRICS}
    assert all(0 < v <= result["metrics"]["forward_host_ms.train"]["value"]
               for v in spans.values()), spans


@pytest.mark.parametrize("fault", ["half", "unchanged"])
def test_a_broken_d_step_is_not_correct(cpu_run, tiny_d, monkeypatch, fault):
    from vbt_tpu_torch.train.train_step import Trainer

    real = Trainer.train_step

    def broken(self, state, batch):
        if fault == "half":
            n = batch["images"].shape[0] // 2
            return real(self, state, {k: v[:n] for k, v in batch.items()})
        return state, real(self, state, batch)[1]

    monkeypatch.setattr(Trainer, "train_step", broken)
    rc, result, err = cpu_run("d3.train")
    assert rc == 0, err
    assert result["correct"] is False
    if fault == "unchanged":
        checks = {c["name"]: c["value"] for c in result["checks"]}
        assert checks["change_gap"] == pytest.approx(1.0)
