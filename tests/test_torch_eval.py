"""The port's detector evaluation against the JAX package's on the CPU,
float32 on both sides.

- The IoU matrix against the reference's scalar ``_iou`` loop and the
  native ``hostops.iou_matrix`` within 1e-12; ``match_bboxes`` gives the
  same pairs (both sides on the Jonker-Volgenant solver: the JAX host lane
  on the native one, built by ``torch_hostops.native_hostops`` if needed).
- ``coco_metrics`` and the PR/ROC figures' APs and AUCs on the repo's
  cached ``dfs/eval_detections.pkl.gz`` equal JAX's within 1e-12.
- A VOC directory the test writes (synthetic plate frames at three sizes
  as JPG, ``plate_boxes`` ground truth as XML, a second object of another
  label): the parsers agree; ``evaluate_model`` of the shipped lite0 on the
  CPU gives JAX's AP, AP50 and AP75 within 1e-12 (no IoU of these
  detections lies within the boxes' float rounding of a threshold);
  ``create_detections_df`` gives JAX's dataframe row for row. Its pixel
  rule: ``scaled_bbox`` truncates to int, and the two forwards' boxes agree
  to 1e-5 of the image (``tests/test_torch_nms.py``), so an integer
  coordinate may differ by one pixel where the float lies within
  ``PIXEL_EPS`` of an integer, and nowhere else; rows of an image without
  such a flip have IoU within 1e-12, those of an image with one within the
  change one pixel makes on a box at least 40 pixels wide (0.05). Scores
  within 3e-5: logits within 1e-4 (tests/test_torch_model.py) through the
  sigmoid, whose slope is at most 1/4.
- ``vbt-torch-eval`` through ``CliRunner``, from the cache and with
  ``--replace_df``; the pipeline's staging rings stay within their bound.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import matplotlib  # noqa: E402

matplotlib.use("Agg")

import pandas as pd  # noqa: E402
from click.testing import CliRunner  # noqa: E402

from torch_hostops import native_hostops  # noqa: E402,F401
from vbt_tpu.cli import eval as jax_eval  # noqa: E402
from vbt_tpu.contract.parsers import read_voc_annotations as jax_read_voc  # noqa: E402
from vbt_tpu.runtime.pipeline import DetectionPipeline as JaxPipeline  # noqa: E402
from vbt_tpu.train import coco_eval as jax_coco  # noqa: E402
from vbt_tpu.train.evaluate import evaluate_model as jax_evaluate_model  # noqa: E402
from vbt_tpu_torch.cli import eval as port_eval  # noqa: E402
from vbt_tpu_torch.contract.parsers import read_voc_annotations  # noqa: E402
from vbt_tpu_torch.io.synthetic import plate_boxes, plate_frames, write_voc  # noqa: E402
from vbt_tpu_torch.runtime import pipeline as port_pipeline  # noqa: E402
from vbt_tpu_torch.runtime.pipeline import DetectionPipeline  # noqa: E402
from vbt_tpu_torch.train import coco_eval  # noqa: E402
from vbt_tpu_torch.train.evaluate import detect_images, evaluate_model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack")
CACHED_DF = os.path.join(REPO, "dfs", "eval_detections.pkl.gz")
SIZES = ((240, 320), (360, 480), (288, 512))  # (h, w) of the VOC images
PIXEL_EPS = 1e-2  # 1e-5 of a 512-pixel side, twice over
SCORE_ATOL = 3e-5
FLIP_IOU_ATOL = 0.05


def _random_boxes(rng, n, span=300):
    yx = np.sort(rng.integers(0, span, size=(n, 2, 2)), axis=1).reshape(-1, 4)
    return yx[:, [0, 2, 1, 3]].astype(np.float64)  # [ymin, xmin, ymax, xmax]


def test_iou_matrix_matches_jax(native_hostops):
    rng = np.random.default_rng(0)
    for _ in range(40):
        gt = _random_boxes(rng, int(rng.integers(1, 6)))
        det = np.concatenate([_random_boxes(rng, int(rng.integers(1, 20))),
                              gt[:1], gt[:1, [0, 1, 0, 1]]])  # equal and empty boxes
        got = port_eval.iou_matrix(gt, det)
        loop = np.array([[jax_eval._iou(d, g) for d in det] for g in gt])
        np.testing.assert_allclose(got, loop, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got, native_hostops.iou_matrix(gt, det), rtol=0, atol=1e-12)
    assert port_eval.iou_matrix(np.zeros((0, 4)), det).shape == (0, len(det))
    assert port_eval.iou_matrix(gt, np.zeros((0, 4))).shape == (len(gt), 0)


def test_match_bboxes_matches_jax(native_hostops):
    rng = np.random.default_rng(11)
    for _ in range(60):
        gt = _random_boxes(rng, int(rng.integers(0, 5)))
        det = _random_boxes(rng, int(rng.integers(1, 30)))
        if rng.uniform() < 0.3:
            det = np.concatenate([gt, det])  # ties: several optimal assignments
        got = port_eval.match_bboxes(gt.astype(int), det.astype(int))
        want = jax_eval.match_bboxes(gt.astype(int), det.astype(int))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_coco_metrics_match_jax():
    rng = np.random.default_rng(3)
    gts = [_random_boxes(rng, int(rng.integers(0, 4))) for _ in range(12)]
    dets = []
    for gt in gts:
        boxes = np.concatenate([gt + rng.normal(0, 6, size=gt.shape), _random_boxes(rng, 5)])
        dets.append({"boxes": boxes, "scores": rng.uniform(size=len(boxes))})
    got, want = coco_eval.coco_metrics(dets, gts), jax_coco.coco_metrics(dets, gts)
    assert got.keys() == want.keys() and 0 < want["AP50"] < 1
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12


def test_curves_of_the_cached_detections_match_jax(tmp_path):
    df = pd.read_pickle(CACHED_DF)
    df["Label"] = df["IoU"] > 0.75
    thresholds = [0.3, 0.5]
    aps = port_eval.plot_precision_recall(df.copy(), str(tmp_path), 0.75, thresholds)
    aucs = port_eval.plot_roc(df.copy(), str(tmp_path), 0.75, thresholds)
    want_dir = tmp_path / "jax"
    want_dir.mkdir()
    want_aps = jax_eval.plot_precision_recall(df.copy(), str(want_dir), 0.75, thresholds)
    want_aucs = jax_eval.plot_roc(df.copy(), str(want_dir), 0.75, thresholds)
    assert len(aps) == 6 and aps.keys() == want_aps.keys() and aucs.keys() == want_aucs.keys()
    for got, want in ((aps, want_aps), (aucs, want_aucs)):
        for m in want:
            assert abs(got[m] - want[m]) <= 1e-12, m
    assert sorted(p.name for p in tmp_path.iterdir() if p.is_file()) == \
        sorted(p.name for p in want_dir.iterdir())


def _write_voc(root):
    """Two synthetic plate frames at each of SIZES as JPG, each with an XML
    holding the analytic plate box (``barbell``) and a box of another label."""
    write_voc(str(root), SIZES)


@pytest.fixture(scope="module")
def voc_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    _write_voc(root)
    return root


@pytest.fixture(scope="module")
def pipelines():
    return (JaxPipeline.from_model_arg(CKPT, use_pallas=False),
            DetectionPipeline.from_model_arg(CKPT, device="cpu"))


def test_plate_boxes_bound_the_drawn_disc():
    frames = plate_frames(3, 120, 200, seed=0, period=7)
    for img, box in zip(frames, plate_boxes(3, 120, 200, period=7)):
        ys, xs = np.nonzero(img[..., 0] == 20)  # the rim, darker than any background cell
        drawn = np.array([ys.min(), xs.min(), ys.max() + 1, xs.max() + 1])
        np.testing.assert_allclose(drawn, box, atol=1.5)


def test_voc_parsers_match_jax(voc_dir):
    got, want = read_voc_annotations(str(voc_dir)), jax_read_voc(str(voc_dir))
    assert got.keys() == want.keys() and len(got) == 2 * len(SIZES)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == (1, 4)
        np.testing.assert_array_equal(got[k], want[k])
    assert all(len(v) == 1 for v in read_voc_annotations(str(voc_dir), label="person").values())


def test_evaluate_model_matches_jax(voc_dir, pipelines):
    jax_pipe, port = pipelines
    got = evaluate_model(port, str(voc_dir))
    want = jax_evaluate_model(jax_pipe, str(voc_dir))
    assert got.keys() == want.keys() and want["AP50"] > 0.9
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got, want)


def _jax_normalized(jax_pipe, img):
    det = jax_pipe.detect_batch(img[None])
    return np.asarray(det.boxes[0][:int(det.count[0])], np.float64)


def test_create_detections_df_matches_jax(voc_dir, pipelines, tmp_path, monkeypatch):
    import cv2

    jax_pipe, _ = pipelines
    # The JAX CLI serves with the Pallas NMS; its XLA postprocess is what the
    # port's CPU lane mirrors, so the JAX side takes that one here.
    jax_from_arg = JaxPipeline.from_model_arg.__func__
    monkeypatch.setattr(JaxPipeline, "from_model_arg", classmethod(
        lambda cls, m, **kw: jax_from_arg(cls, m, use_pallas=False, **kw)))
    annotations = jax_read_voc(str(voc_dir))
    want = jax_eval.create_detections_df([CKPT], str(voc_dir), annotations,
                                         str(tmp_path / "jax.pkl.gz"))
    got = port_eval.create_detections_df([CKPT], str(voc_dir), read_voc_annotations(str(voc_dir)),
                                         str(tmp_path / "port.pkl.gz"), device="cpu")
    assert list(got.columns) == ["Score", "Model", "IoU"]
    pd.testing.assert_frame_equal(pd.read_pickle(tmp_path / "port.pkl.gz"), got)
    assert len(got) == len(want) and (got["Model"] == want["Model"]).all()
    assert got["Score"].dtype == want["Score"].dtype == np.float32
    np.testing.assert_allclose(got["Score"], want["Score"], rtol=0, atol=SCORE_ATOL)

    # The pixel rule, image by image, then the IoU of each image's rows.
    port = DetectionPipeline.from_model_arg(CKPT, device="cpu")
    row = 0
    for file in annotations:
        img = cv2.cvtColor(cv2.imread(str(voc_dir / file)), cv2.COLOR_BGR2RGB)
        mine = port_eval.image_detections(port, img)["boxes"]
        normalized = _jax_normalized(jax_pipe, img)
        theirs = np.stack([jax_eval.scaled_bbox(b, (1, 1), img.shape[:2]) for b in normalized])
        pixels = normalized * np.array(img.shape[:2] * 2)
        assert mine.shape == theirs.shape
        flipped = mine != theirs
        assert (np.abs(mine - theirs) <= 1).all()
        assert (np.abs(pixels - np.rint(pixels))[flipped] <= PIXEL_EPS).all()
        n = len(mine)  # one row a detection: every detection is matched
        atol = FLIP_IOU_ATOL if flipped.any() else 1e-12
        np.testing.assert_allclose(got["IoU"][row:row + n], want["IoU"][row:row + n],
                                   rtol=0, atol=atol)
        row += n
    assert row == len(got)


def test_detect_images_batch_one_at_each_size(voc_dir, pipelines):
    import cv2

    _, port = pipelines
    files = sorted(voc_dir.glob("*.jpg"))
    images = [cv2.cvtColor(cv2.imread(str(f)), cv2.COLOR_BGR2RGB) for f in files]
    dets = detect_images(port, images)
    truth = read_voc_annotations(str(voc_dir))
    gts = [truth[f.name].astype(np.float64) for f in files]
    truth_of = {id(img): gt for img, gt in zip(images, gts)}
    metrics = coco_eval.coco_metrics(dets, gts)
    assert metrics["AP50"] > 0.9
    for d, img in zip(dets, images):
        assert d["boxes"].dtype == np.float64 and np.isfinite(d["boxes"]).all()
        # The top box is the plate's, in this image's pixels.
        assert port_eval.iou_matrix(d["boxes"][:1], truth_of[id(img)])[0, 0] > 0.75


def _cpu_pipelines(monkeypatch):
    # The CLI serves on the card and probes it first; its pipelines are
    # moved to the CPU here, so the probe of the card is turned off.
    monkeypatch.setenv("VBT_TORCH_HEALTH_PROBE", "0")
    from_arg = DetectionPipeline.from_model_arg.__func__
    monkeypatch.setattr(DetectionPipeline, "from_model_arg", classmethod(
        lambda cls, m, device="cuda", **kw: from_arg(cls, m, device="cpu", **kw)))


def test_eval_cli_from_cache_and_replaced(voc_dir, tmp_path, monkeypatch):
    runner = CliRunner()
    figs = tmp_path / "figs"
    args = ["--img_dir", str(voc_dir), "--annotations_dir", str(voc_dir), "--fig_dir", str(figs)]
    cached = runner.invoke(port_eval.make_command(),
                           args + ["--detections_df", CACHED_DF, "--iou_threshold", "0.5"],
                           catch_exceptions=False)
    assert cached.exit_code == 0 and "Loading dataframe" in cached.output
    assert (figs / "precision_recall_iou_0.5.pdf").exists() and (figs / "roc_iou_0.5.pdf").exists()

    _cpu_pipelines(monkeypatch)
    out = tmp_path / "dfs" / "eval.pkl.gz"
    replaced = runner.invoke(port_eval.make_command(),
                             args + ["--detections_df", str(out), "--replace_df",
                                     "--score_thresholds", "[0.5]", "--iou_threshold", "0.75",
                                     CKPT], catch_exceptions=False)
    assert replaced.exit_code == 0 and "Creating dataframe" in replaced.output
    df = pd.read_pickle(out)
    assert set(df["Model"]) == {"efficientdet_lite0_whole"} and len(df) >= len(SIZES) * 2
    assert (figs / "roc_efficientdet_lite0_whole_iou_0.75.pdf").exists()
    bad = runner.invoke(port_eval.make_command(), args + ["--score_thresholds", "[0.5", CKPT])
    assert bad.exit_code != 0
    assert [p.name for p in port_eval.make_command().params] == \
        [p.name for p in jax_eval.main.params]


def test_staging_rings_stay_bounded():
    pipe = DetectionPipeline.from_model_arg(CKPT, device="cpu")
    shapes = [(1, 32, 32 + 8 * i, 3) for i in range(port_pipeline.MAX_RINGS + 3)]
    rings = []
    for shape in shapes:
        rings.append(pipe.staging(shape))
        assert len(pipe.rings) <= port_pipeline.MAX_RINGS
    assert list(pipe.rings) == shapes[-port_pipeline.MAX_RINGS:]
    assert all(r.buffers == [] for r in rings[:3]) and all(r.buffers for r in rings[3:])

    class Copy:  # stands for a copy event still in flight
        waited = 0

        def synchronize(self):
            Copy.waited += 1

    oldest = pipe.rings[shapes[3]]
    oldest.copied[1] = Copy()
    pipe.staging(shapes[4])  # used again: now the most recent
    assert list(pipe.rings)[-1] == shapes[4]
    pipe.staging((1, 16, 16, 3))
    assert shapes[3] not in pipe.rings and Copy.waited == 1 and oldest.buffers == []
    dets = [pipe.detect_batch(np.zeros((1, 24 + 8 * i, 40, 3), np.uint8))
            for i in range(port_pipeline.MAX_RINGS + 2)]
    assert len(pipe.rings) == port_pipeline.MAX_RINGS and all(d.count.shape == (1,) for d in dets)
