"""The port's "prove or retire" tools (``vbt_tpu_torch/tools/turbo_check.py``
and ``prefilter_check.py``) against the JAX package's on the CPU.

JAX's tools match the detections of two lanes inside their ``main``, which
reads the reference test images (absent). So the statements of that
matching are taken from JAX's source (``ast``, from the ``count_match``
or ``n_img`` assignment to the verdict) and run on seeded detections, and
the port's ``compare`` must give the same counts and maxima exactly, over
lanes that agree, lanes perturbed within the budget and beyond it, and
rows reordered, dropped or added. ``_iou_one_to_many`` equals JAX's
bit for bit.

Each tool's CPU lane runs on 4 synthetic plate images, with the speed half
at B = 2 and its loops cut to one trial of 1 and 3 calls, and exits 0.
The files of this slice run torch on one thread (``tests/torch_threads.py``):
with a thread a core in each of the tier-1 run's workers, these CPU lanes
took minutes.
"""

import ast
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

from tools import prefilter_check as jax_prefilter  # noqa: E402
from tools import turbo_check as jax_turbo  # noqa: E402
from vbt_tpu_torch.tools import prefilter_check, turbo_check  # noqa: E402

N_IMG, D = 8, 25


def _jax_matching(module, first: str, last: str, **names) -> dict:
    """Run the statements of ``module.main`` from the assignment to
    ``first`` through the assignment to ``last`` with ``names`` bound;
    returns the namespace."""
    fn = ast.parse(inspect.getsource(module.main)).body[0]
    targets = [getattr(getattr(s, "targets", [None])[0], "id", None) for s in fn.body]
    body = fn.body[targets.index(first):targets.index(last) + 1]
    ns = {**vars(module), **names}
    exec(compile(ast.Module(body=body, type_ignores=[]), module.__file__, "exec"), ns)
    return ns


def _lanes(seed: int, noise: float, names: tuple[str, str]) -> tuple[dict, dict, dict]:
    """Seeded detections of two lanes: the second is the first with every
    box and score moved by up to ``noise``, rows of each image permuted among
    near-equal scores, and counts changed in a few images."""
    rng = np.random.default_rng(seed)
    ref, other = names
    counts = {ref: rng.integers(0, D + 1, N_IMG)}
    yx = rng.uniform(0, 0.8, (N_IMG, D, 2))
    hw = rng.uniform(0.05, 0.2, (N_IMG, D, 2))
    boxes = {ref: np.concatenate([yx, yx + hw], -1).astype(np.float32)}
    scores = {ref: np.sort(rng.uniform(0, 1, (N_IMG, D)).astype(np.float32))[:, ::-1].copy()}
    boxes[other] = (boxes[ref] + rng.uniform(-noise, noise, boxes[ref].shape)).astype(np.float32)
    scores[other] = (scores[ref] + rng.uniform(-noise, noise, scores[ref].shape)).astype(
        np.float32)
    counts[other] = counts[ref].copy()
    for i in range(N_IMG):
        j = rng.integers(0, D - 1)
        for a in (boxes[other], scores[other]):
            a[i, [j, j + 1]] = a[i, [j + 1, j]]
    if seed % 2:
        counts[other][:2] = np.clip(counts[other][:2] + [1, -1], 0, D)
    return counts, boxes, scores


CASES = [(seed, noise) for seed in range(4) for noise in (0.0, 1e-3, 3e-2)]


@pytest.mark.parametrize("seed,noise", CASES)
def test_turbo_matching_equals_jax(seed, noise):
    counts, boxes, scores = _lanes(seed, noise, ("xla", "turbo"))
    got = turbo_check.compare(counts, boxes, scores)
    ns = _jax_matching(jax_turbo, "count_match", "numerics_ok", counts=counts, boxes=boxes,
                       scores=scores, files=[None] * N_IMG)
    assert got == {"numerics_ok": ns["numerics_ok"], "images": N_IMG,
                   "count_match": ns["count_match"], "score_delta": ns["smax"],
                   "box_delta": ns["bmax"], "unmatched_confident": ns["unmatched_conf"],
                   "unmatched_tail": ns["unmatched_tail"], "tail_box_delta": ns["tail_bmax"]}


@pytest.mark.parametrize("tool,names", [(turbo_check, ("xla", "turbo")),
                                        (prefilter_check, ("exact", "approx"))],
                         ids=["turbo", "prefilter"])
def test_verdicts(tool, names):
    """Equal lanes pass; a confident box moved by twice the budget fails."""
    counts, boxes, scores = _lanes(0, 0.0, names)
    ref, other = names
    counts[other], boxes[other], scores[other] = counts[ref], boxes[ref].copy(), scores[ref]
    verdict = next(iter(tool.compare(counts, boxes, scores).values()))
    assert verdict is True
    i = int(np.argmax(counts[ref]))
    boxes[other][i, 0, 2:] += 2 * tool.BUDGET_BOX
    assert next(iter(tool.compare(counts, boxes, scores).values())) is False


@pytest.mark.parametrize("seed,noise", CASES)
def test_prefilter_matching_equals_jax(seed, noise):
    counts, boxes, scores = _lanes(seed, noise, ("exact", "approx"))
    got = prefilter_check.compare(counts, boxes, scores)
    ns = _jax_matching(jax_prefilter, "n_img", "ok", counts=counts, boxes=boxes, scores=scores,
                       files=[None] * N_IMG)
    assert got == {"ok": ns["ok"], "images": N_IMG, "count_match": ns["count_match"],
                   "track_rows_ok": bool(ns["track_rows_ok"]),
                   "unmatched_confident": ns["unmatched_confident"], "score_delta": ns["smax"],
                   "box_delta": ns["bmax"], "tail_rows": ns["tail_rows"],
                   "total_rows": ns["total_rows"], "tail_score_delta": ns["tail_smax"],
                   "tail_box_delta": ns["tail_bmax"]}


def test_iou_one_to_many_equals_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, 4).astype(np.float32)
    b = rng.uniform(0, 1, (50, 4)).astype(np.float32)
    np.testing.assert_array_equal(turbo_check._iou_one_to_many(a, b),
                                  jax_turbo._iou_one_to_many(a, b))


@pytest.mark.parametrize("tool", [turbo_check, prefilter_check], ids=["turbo", "prefilter"])
def test_cpu_lane_exits_zero(tool, monkeypatch, capsys):
    monkeypatch.setattr(turbo_check, "N_SHORT", 1)
    monkeypatch.setattr(turbo_check, "N_LONG", 3)
    monkeypatch.setattr(turbo_check, "TRIALS", 1)
    monkeypatch.setattr(prefilter_check, "TRIALS", 1)
    assert tool.main(["--n_images", "4", "--batches", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "4/4 images count-equal" in out or "count-equal: 4/4" in out
    assert out.count(" b2: ") == 2
