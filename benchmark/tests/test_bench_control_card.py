"""The controls on the card, at a size a test run can hold: the nearest
precision below each configuration's must come out not correct.

Card only (``cuda`` marker; skipped here with a reason). On the card:
``python -m pytest --noconftest -m cuda benchmark/tests/test_bench_control_card.py``
(``--noconftest`` leaves out ``tests/``'s, which pins JAX to the CPU).
The chip readings at each cell's own size are ``benchmark/tools/readings.py``'s.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = {
    "track": dict(frames=192, videos=1),
    "stream": dict(frames=192, sets=1),
    "train": dict(images=128),
}


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls read the card's precisions")


@pytest.mark.cuda
@pytest.mark.parametrize("workload,control", [
    ("lite0.track", "int8"), ("lite0.stream", "int8"), ("lite0.track", "k3_bf16"),
    ("lite0.stream", "k4_f32"), ("lite0.train", "tf32"), ("lite0.train", "half")])
def test_the_control_is_not_correct(workload, control, monkeypatch):
    _card()
    from benchmark.core import registry
    from benchmark.tests.held_out import with_held_out
    from benchmark.tools.readings import reading

    with_held_out(monkeypatch)

    bench = registry.benchmark()
    mix = registry.mix(registry.workload(bench, workload)["traffic"])
    got, _ = reading(workload, 2**31 + 17, 2.0, control, mix_update=SMALL[mix["driver"]])
    limits = registry.limits(workload)
    assert any(got[name] > limit for name, limit in limits.items()), got
