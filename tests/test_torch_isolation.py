"""The port stands alone: importing every module of ``vbt_tpu_torch`` loads
no ``jax``, ``flax`` or ``vbt_tpu`` module, nor the optional host packages
(cv2, pandas, click, matplotlib, seaborn, sklearn) that ``chip_smoke.py``
runs without; and a CUDA request
on a machine without a card raises instead of falling back to the CPU."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import vbt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vbt_tpu_torch.__path__, "vbt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "vbt_tpu", "cv2", "pandas", "click",
                                    "matplotlib", "seaborn", "sklearn"))
print(len(names))
print(",".join(bad))
print(",".join(names))
"""


def test_import_loads_no_jax_or_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    count, bad, names = (out.stdout + "\n").split("\n")[:3]
    assert int(count) >= 50, out.stdout  # every module of the slice was imported
    for module in ("analysis.velocity_torch", "cli.plot", "ops.track_scan_cuda",
                   "runtime.batch_runner", "runtime.upload", "tracking.scan",
                   "analysis.smoother_scan", "ops.analysis_scan_cuda", "runtime.streaming",
                   "cli.stream", "parallel.mesh", "parallel.time_shard", "models.quant",
                   "contract.parsers", "train.coco_eval", "train.evaluate", "cli.eval",
                   "train.losses", "train.targets", "train.augment", "train.data",
                   "train.train_step", "train.fused", "cli.train", "cli.data_prep",
                   "cli.training_plot", "cli._groundtruth", "cli.kinovea", "cli.qualisys",
                   "contract.golden", "utils.cache", "utils.health", "utils.profiling",
                   "tracking.sort", "tools.ckpt_sweep", "tools.ckpt_soup", "tools.int8_delta",
                   "tools.gen_eval_figs", "tools.gen_docs_pngs"):
        assert f"vbt_tpu_torch.{module}" in names.split(","), module
    assert bad == "", f"port imported {bad}"


def test_sources_name_no_jax_or_reference_import():
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|vbt_tpu)\b", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "vbt_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the no-card refusal is what is tested")
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
    from vbt_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        DetectionPipeline.from_model_arg(
            os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack"))
    with pytest.raises(ValueError):
        resolve_device("mps")
