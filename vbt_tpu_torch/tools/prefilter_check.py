"""Prove or retire the approximate NMS prefilter on the card.

Port of the JAX package's ``tools/prefilter_check.py``. JAX's ``"approx"``
prefilter is ``lax.approx_max_k``, which may return another candidate set
on the TPU and is the exact top-K elsewhere; the port serves ``"approx"``
with the exact top-K (``ops/postprocess.py::approx_top_k``), so this tool
holds the named branch to the exact one until a kernel takes its place:

1. **Numerics**: the shipped lite0 checkpoint over the reference's test
   images or, where ``reference/data/test`` holds none, synthetic plates
   (``turbo_check.numerics_images``, as in :mod:`.turbo_check`; the
   ``images:`` line names the source), ``prefilter="exact"`` against
   ``"approx"``, the device's serving dtype (bf16 and K1 on the card).
   JAX's matching and budgets (:func:`compare`): counts equal, the count
   of rows at or above ``TRACK_THRESHOLD`` (the score the tracker
   thresholds at) equal in every image, every confident row (score >
   ``CONFIDENT``) matched at IoU >= 0.5 within ``BUDGET_BOX`` and
   ``BUDGET_SCORE``; the tail is reported, not gated.
2. **Speed**: the marginal ms of the whole ``detect_batch`` (JAX's 4/12
   loops, 5 trials) at B = 64 and 128, exact against approx.

Exit code 1 when the numerics diverge beyond the budget.

Usage: ``python -m vbt_tpu_torch.tools.prefilter_check [--n_images 32] [--batches 64 128] [--device cpu]``
"""

from __future__ import annotations

import numpy as np

from vbt_tpu_torch.tools import turbo_check
from vbt_tpu_torch.tools._timing import prepare_device
from vbt_tpu_torch.tools.turbo_check import (BUDGET_BOX, BUDGET_SCORE, CONFIDENT,
                                             _iou_one_to_many)

TRACK_THRESHOLD = 0.5
TRIALS = 5  # JAX's tool; its loops are turbo_check's 4 and 12 calls


def compare(counts: dict, boxes: dict, scores: dict) -> dict:
    """JAX's matching of the approx rows to the exact ones
    (``tools/prefilter_check.py:111-160``)."""
    n_img = len(counts["exact"])
    count_match = int((counts["exact"] == counts["approx"]).sum())
    track_rows_ok = True
    smax = bmax = 0.0
    tail_smax = tail_bmax = 0.0
    unmatched_confident = 0
    tail_rows = total_rows = 0
    for i in range(n_img):
        ce, ca = int(counts["exact"][i]), int(counts["approx"][i])
        n_track_e = int((scores["exact"][i, :ce] >= TRACK_THRESHOLD).sum())
        n_track_a = int((scores["approx"][i, :ca] >= TRACK_THRESHOLD).sum())
        track_rows_ok &= n_track_e == n_track_a
        used = np.zeros(ca, bool)
        for r in range(ce):
            total_rows += 1
            se = scores["exact"][i, r]
            be = boxes["exact"][i, r]
            if ca == 0:
                if se > CONFIDENT:
                    unmatched_confident += 1
                continue
            ious = _iou_one_to_many(be, boxes["approx"][i, :ca])
            ious[used] = -1
            j = int(np.argmax(ious))
            if se > CONFIDENT:
                if ious[j] < 0.5:
                    unmatched_confident += 1
                    continue
                used[j] = True
                smax = max(smax, abs(float(se - scores["approx"][i, j])))
                bmax = max(bmax, float(np.max(np.abs(be - boxes["approx"][i, j]))))
            else:
                tail_rows += 1
                if ious[j] >= 0.5:
                    used[j] = True
                    tail_smax = max(tail_smax, abs(float(se - scores["approx"][i, j])))
                    tail_bmax = max(tail_bmax, float(np.max(np.abs(be - boxes["approx"][i, j]))))
    ok = (count_match == n_img and bool(track_rows_ok) and unmatched_confident == 0
          and smax <= BUDGET_SCORE and bmax <= BUDGET_BOX)
    return {"ok": ok, "images": n_img, "count_match": count_match,
            "track_rows_ok": bool(track_rows_ok), "unmatched_confident": unmatched_confident,
            "score_delta": smax, "box_delta": bmax, "tail_rows": tail_rows,
            "total_rows": total_rows, "tail_score_delta": tail_smax,
            "tail_box_delta": tail_bmax}


def main(argv=None) -> int:
    args = turbo_check.parse(argv, __doc__)
    dev = prepare_device(args.device, "prefilter_check")
    pipes = turbo_check.pipelines(dev, exact={"prefilter": "exact"},
                                  approx={"prefilter": "approx"})
    size = pipes["exact"].spec.input_size
    images, source = turbo_check.numerics_images(args.n_images, size)
    r = compare(*turbo_check.detections(pipes, images))
    print(f"images: {r['images']} ({source})  count-equal: {r['count_match']}/{r['images']}  "
          f"track-threshold rows equal: {r['track_rows_ok']}")
    print(f"confident rows: unmatched {r['unmatched_confident']}, "
          f"max |score d| {r['score_delta']:.2e}, max |box d| {r['box_delta']:.2e}")
    print(f"tail rows ({r['tail_rows']}/{r['total_rows']}): "
          f"max |score d| {r['tail_score_delta']:.2e}, max |box d| {r['tail_box_delta']:.2e}",
          flush=True)
    turbo_check.speed(pipes, args.batches, size, dev, trials=TRIALS)
    print("PASS" if r["ok"] else "FAIL (numerics beyond budget)")
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
