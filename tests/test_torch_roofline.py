"""The port's analytic count of the serving path's work
(``vbt_tpu_torch/tools/roofline.py``) against the JAX package's and
against counts of the port's own forward, on the CPU.

- ``analytic_bytes`` equals JAX's ``tools/roofline.py::analytic_bytes``
  exactly, the whole dict, at three (batch, size) points;
- ``analytic_flops`` (2 x MACs of every convolution, read from the spec)
  equals ``torch.utils.flop_counter.FlopCounterMode``'s count of the port's
  float32 forward exactly, stage by stage (backbone, BiFPN, the two heads),
  for lite0 at B = 2 and 320 px: 3,437,108,480 FLOPs;
- it lies within 5% of XLA's cost analysis of JAX's compiled ``_forward``
  at the same size (3,543,827,712 FLOPs, 3.1% more: XLA also counts the
  elementwise work, BatchNorm, ReLU6, the sums and the preprocess);
- each stage's bound is the larger of bytes over 3.35 TB/s and FLOPs over
  989 TFLOP/s.
"""

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

import jax.numpy as jnp  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from tools import roofline as jax_roofline  # noqa: E402
from vbt_tpu.models import get_model_spec as jax_spec  # noqa: E402
from vbt_tpu.runtime.pipeline import DetectionPipeline as JaxPipeline  # noqa: E402
from vbt_tpu_torch.models import EfficientDet, get_model_spec  # noqa: E402
from vbt_tpu_torch.tools import roofline  # noqa: E402

XLA_TOL = 0.05  # analytic (convolutions only) against XLA's count (everything)


@pytest.mark.parametrize("batch,size", [(128, 320), (8, 320), (2, 384)])
def test_analytic_bytes_equal_jax(batch, size):
    assert roofline.analytic_bytes(batch, size) == jax_roofline.analytic_bytes(batch, size)


def test_analytic_flops_equal_the_flop_counter():
    model = EfficientDet(get_model_spec("efficientdet_lite0")).eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(torch.zeros(2, 3, 320, 320))
    by_module = {k: sum(v.values()) for k, v in counter.get_flop_counts().items()}
    want = roofline.analytic_flops(2, 320)
    assert sum(want.values()) == counter.get_total_flops() == 3_437_108_480
    assert want["backbone"] == by_module["EfficientDet.backbone"]
    assert want["bifpn"] == by_module["EfficientDet.fpn"]
    assert want["heads"] == by_module["EfficientDet.box_net"] + by_module["EfficientDet.class_net"]
    assert want["preprocess"] == want["postprocess"] == 0


def test_analytic_flops_near_xla_cost_analysis():
    spec = jax_spec("efficientdet_lite0")
    pipe = JaxPipeline(spec=spec, variables=JaxPipeline.init_variables(spec), use_pallas=False)
    frames = jnp.zeros((2, 320, 320, 3), jnp.uint8)
    cost = pipe._forward.lower(pipe.variables, frames).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    xla = float(cost["flops"])
    ours = sum(roofline.analytic_flops(2, 320).values())
    assert abs(ours - xla) <= XLA_TOL * xla, (ours, xla)


def test_stage_bounds_use_the_h100_peaks():
    rows = {r["stage"]: r for r in roofline.stage_rows(128, 320)}
    nbytes, flops = roofline.analytic_bytes(128, 320), roofline.analytic_flops(128, 320)
    assert list(rows) == list(roofline.STAGES)
    for stage, r in rows.items():
        assert r["t_hbm_ms"] == pytest.approx(nbytes[stage] / 3.35e12 * 1e3)
        assert r["t_tc_ms"] == pytest.approx(flops[stage] / 989e12 * 1e3)
        assert r["t_bound_ms"] == max(r["t_hbm_ms"], r["t_tc_ms"])
        assert r["gb"] == nbytes[stage] / 1e9 and r["gflop"] == flops[stage] / 1e9
