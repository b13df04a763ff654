"""EfficientDet-D7x's train cell (``d7x.train``: ``drivers/train_d7x.py``,
``reference/effdet_d7x/``, ``counts/flops_d7x.py``) through the whole
harness on the CPU, at a tiny six-level, sum-fusion D spec in D7x's place
(the B0 backbone at 64 px, BiFPN 16 x 1 over P3-P8, one head repeat): the
weights drawn from the seed and written in the checkpoint layout at
set-up; a sound run is correct and a traced one prints ``mfu_d7x.train``;
a step that leaves out half its batch, or keeps its state, is not correct.
Besides: the reference's parameter list is the program's D7x state dict at
published widths, name for name and shape for shape; the seeded checkpoint
loads into the program bit for bit; the reference recomputing by blocks
steps as it does without (float64), its running statistics from the first
pass; ``graph_pool_share.train`` reads the gauge over the card's memory,
and nothing from a program without it. D7x itself is too large for this
CPU; the card runs it."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

TINY_SPEC = "efficientdet_d7xtiny"


def _tiny_specs(monkeypatch):
    from benchmark.reference.effdet_d7x import model as plain
    from vbt_tpu_torch.models import MODEL_SPECS, ModelSpec

    spec = ModelSpec(TINY_SPEC, "b0", 64, 16, 1, 1, anchor_scale=4.0, act="swish",
                     fusion="sum", max_level=8)
    monkeypatch.setitem(MODEL_SPECS, TINY_SPEC, spec)
    monkeypatch.setitem(plain.D_SPECS, TINY_SPEC, plain.DSpec(1.0, 1.0, 64, 16, 1, 1,
                                                              fusion="sum", max_level=8))
    return spec


@pytest.fixture
def tiny_d7x(monkeypatch):
    """``d7x`` resolves to a tiny six-level D spec."""
    from benchmark.core import registry

    _tiny_specs(monkeypatch)
    real = registry.config

    def config(bench, name):
        got = real(bench, name)
        return dict(got, spec=TINY_SPEC) if name == "d7x" else got

    monkeypatch.setattr(registry, "config", config)
    conftest = sys.modules["benchmark.tests.conftest"]
    monkeypatch.setitem(conftest.TINY, "train_d7x", conftest.TINY["train"])


def test_a_small_d7x_run_is_correct(cpu_run, tiny_d7x):
    rc, result, err = cpu_run("d7x.train")
    assert rc == 0, err
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"train_img_per_s", "setup_s"}
    assert "check late stage" in err


def test_a_traced_d7x_run_prints_its_metrics(cpu_run, tiny_d7x):
    rc, result, err = cpu_run("d7x.train", trace=1)
    assert rc == 0, err
    assert result["correct"] is True, result["checks"]
    got = set(result["metrics"])
    assert {"mfu_d7x.train", "step_host_share.train"} <= got
    assert not got & {"mfu_effdet.train", "mfu.train", "graph_pool_share.train"}


@pytest.mark.parametrize("fault", ["half", "unchanged"])
def test_a_broken_d7x_step_is_not_correct(cpu_run, tiny_d7x, monkeypatch, fault):
    from vbt_tpu_torch.train.train_step import Trainer

    real = Trainer.train_step

    def broken(self, state, batch):
        if fault == "half":
            n = batch["images"].shape[0] // 2
            return real(self, state, {k: v[:n] for k, v in batch.items()})
        return state, real(self, state, batch)[1]

    monkeypatch.setattr(Trainer, "train_step", broken)
    rc, result, err = cpu_run("d7x.train")
    assert rc == 0, err
    assert result["correct"] is False
    if fault == "unchanged":
        checks = {c["name"]: c["value"] for c in result["checks"]}
        assert checks["change_gap"] == pytest.approx(1.0)


def test_the_reference_lists_the_programs_d7x_weights():
    from benchmark.reference.effdet_d7x.model import D_SPECS, parameter_shapes
    from vbt_tpu_torch.models import EfficientDet, get_model_spec

    want = {k: tuple(v.shape) for k, v in EfficientDet(get_model_spec("efficientdet_d7x"))
            .state_dict().items()}
    got = parameter_shapes(D_SPECS["efficientdet_d7x"])
    assert {k: shape for k, (_, shape) in got.items()} == want
    assert not any(kind == "edge" for kind, _ in got.values())  # sum fusion: no weights
    assert "fpn.cell7.bu_p8.conv.bn.running_var" in got and "class_net.bn4_p8.weight" in got


def test_the_seeded_checkpoint_loads_into_the_program(monkeypatch, tmp_path):
    from benchmark.reference.effdet_d7x.step import load_checkpoint, seeded_weights, \
        write_seeded_checkpoint
    from vbt_tpu_torch.models import EfficientDet
    from vbt_tpu_torch.runtime.checkpoint import load_params

    spec = _tiny_specs(monkeypatch)
    path = str(tmp_path / "w.msgpack")
    write_seeded_checkpoint(TINY_SPEC, 2**31 + 7, path)
    want = seeded_weights(TINY_SPEC, 2**31 + 7)
    got = load_params(path, EfficientDet(spec).state_dict())
    ref = load_checkpoint(path)
    assert got.keys() == want.keys() == ref.keys()
    assert all(torch.equal(got[k], want[k]) and torch.equal(ref[k], want[k]) for k in want)
    again = seeded_weights(TINY_SPEC, 2**31 + 7)
    other = seeded_weights(TINY_SPEC, 2**31 + 8)
    w = "backbone.g1_b0.expand.weight"
    assert torch.equal(again[w], want[w]) and not torch.equal(other[w], want[w])
    assert float(want["class_net.final.pointwise.bias"][0]) == pytest.approx(-4.59512, abs=1e-5)
    assert float(want["box_net.bn0_p8.running_var"][0]) == 1.0


def test_recomputing_by_blocks_steps_as_the_plain_step(monkeypatch, tmp_path):
    from benchmark.reference.effdet_d7x import model as plain
    from benchmark.reference.effdet_d7x.step import PlainTrainer, write_seeded_checkpoint

    _tiny_specs(monkeypatch)
    path = str(tmp_path / "w.msgpack")
    write_seeded_checkpoint(TINY_SPEC, 3, path)
    gen = torch.Generator().manual_seed(4)
    images = torch.randn(2, 3, 64, 64, generator=gen, dtype=torch.float64)
    boxes = torch.tensor([[[8.0, 8.0, 40.0, 36.0]], [[20.0, 4.0, 52.0, 30.0]]])
    valid = torch.ones(2, 1, dtype=torch.bool)
    runs = []
    for recompute in (False, True):
        ref = PlainTrainer(TINY_SPEC, path, 0.01, 100, 5, "cpu", dtype=torch.float64,
                           recompute=recompute)
        outs = [ref.step(images, boxes, valid) for _ in range(2)]
        runs.append((outs, ref.state()))
    (plain_outs, plain_state), (re_outs, re_state) = runs
    for a, b in zip(plain_outs, re_outs):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-12)
        for k in a["opt_grad"]:
            torch.testing.assert_close(b["opt_grad"][k], a["opt_grad"][k], rtol=1e-10,
                                       atol=1e-14)
    for part in ("params", "ema", "stats"):
        for k, v in plain_state[part].items():
            torch.testing.assert_close(re_state[part][k], v, rtol=1e-10, atol=1e-14)
    # A recomputation leaves the first pass's statistics.
    net = plain.Net(plain.D_SPECS[TINY_SPEC], {}, True)
    x = torch.ones(1, 2, 2, 2, dtype=torch.float64)
    net.w = {"b.weight": torch.ones(2, dtype=torch.float64),
             "b.bias": torch.zeros(2, dtype=torch.float64),
             "b.running_mean": torch.zeros(2, dtype=torch.float64),
             "b.running_var": torch.ones(2, dtype=torch.float64)}
    net.bn("b", x)
    net.bn("b", 3 * x)
    assert float(net.stats["b.running_mean"][0]) == pytest.approx(0.01)


def test_graph_pool_share_reads_the_gauge(monkeypatch):
    from benchmark.core import registry
    from vbt_tpu_torch.runtime import graphs

    read = registry.metric_reader("graph_pool_share.train")
    run = SimpleNamespace(cell=SimpleNamespace(counters={"steps": 4}), window_s=1.0)
    monkeypatch.setattr(graphs, "_POOL_BYTES", {})
    assert read(run) is None  # no train graph captured
    monkeypatch.setattr(graphs, "_POOL_BYTES", {"detect": 10, "train": 20 * 2**30})
    assert read(run) is None  # no card to hold it against
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: SimpleNamespace(total_memory=80 * 2**30))
    assert read(run) == pytest.approx(25.0)
    monkeypatch.delattr(graphs, "pool_bytes")  # a program without the gauge
    assert read(run) is None
