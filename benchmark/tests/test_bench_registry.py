"""The harness finds every configuration, mix, limit and metric by name,
and a new metric file is read without an edit."""

import json
import shutil

import pytest

from benchmark.core import registry


def test_every_cell_resolves_by_name():
    bench = registry.benchmark()
    for wl in bench["workloads"]:
        config = registry.config(bench, wl["config"])
        mix = registry.mix(wl["traffic"])
        limits = registry.limits(wl["name"])
        assert config["spec"].startswith("efficientdet_")
        assert (registry.ROOT / config["checkpoint"]).is_file()
        assert hasattr(registry.driver(mix["driver"]), "Cell")
        assert limits and all(v >= 0 for v in limits.values())  # 0: an exact comparison
        for traced in (False, True):
            assert registry.cell_metrics(bench, wl["name"], traced)


def test_every_metric_has_a_reader_and_a_cell_that_reports_its_moves():
    bench = registry.benchmark()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert registry.applies(moved, w), (m["name"], w)


def test_a_new_metric_file_is_picked_up(tmp_path, monkeypatch):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(registry.BENCH_DIR / "metrics", bench_dir / "metrics")
    (bench_dir / "metrics" / "new_metric.track.py").write_text(
        "def read(run):\n    return 2.0 * run.window_s\n")
    monkeypatch.setattr(registry, "BENCH_DIR", bench_dir)

    class Run:
        window_s = 3.0

    assert registry.metric_reader("new_metric.track")(Run()) == 6.0


def test_benchmark_json_keeps_the_contracts_shape():
    bench = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in bench["end_to_end"])
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for wl in bench["workloads"]:
        assert wl["chips"] == 1 and len(wl["why"]) <= 200


@pytest.mark.parametrize("name", ["efficientdet_lite0", "efficientdet_lite2"])
def test_frozen_flops_match_the_published_counts(name):
    from benchmark.counts.flops import forward_flops

    want = {"efficientdet_lite0": 1.719e9, "efficientdet_lite2": 5.956e9}[name]
    assert forward_flops(name) == pytest.approx(want, rel=5e-4)
