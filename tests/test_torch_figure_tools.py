"""The port's figure tools against the JAX package's on the CPU.

``vbt_tpu_torch.tools.gen_eval_figs`` and ``.gen_docs_pngs`` against
``tools/gen_eval_figs.py`` and ``tools/gen_docs_pngs.py`` (``python -m
pytest`` puts the repository root on ``sys.path``, so ``tools`` imports).
Both read the reference project's files, which the repository does not
hold, so the test writes stand-ins and points both sides' constants at them
with ``monkeypatch``: a reference cache of two models' rows of
``dfs/eval_detections.pkl.gz`` (every third row), and a golden track
dataframe of ``io/synthetic.py``'s plate under the filename grammar. Held:

- the merged detections equal JAX's ``merged_detections()`` exactly;
- each tool, run through click's ``CliRunner``, writes the same files and
  prints the same lines as JAX's (the output directory aside);
- the port's PR/ROC functions give JAX's APs and AUCs on the merged frame
  within 1e-12;
- with the reference inputs absent, the port's tools print a line for
  each, draw ours alone and exit 0 (JAX's raise there).
"""

import os

import pytest

pd = pytest.importorskip("pandas")
pytest.importorskip("matplotlib")
pytest.importorskip("seaborn")
pytest.importorskip("sklearn")
click_testing = pytest.importorskip("click.testing")

from tools import gen_docs_pngs as jax_docs  # noqa: E402
from tools import gen_eval_figs as jax_figs  # noqa: E402
from vbt_tpu.cli import eval as jax_eval  # noqa: E402
from vbt_tpu_torch.cli import eval as port_eval  # noqa: E402
from vbt_tpu_torch.contract.schema import build_df_filename, build_track_df  # noqa: E402
from vbt_tpu_torch.io.synthetic import plate_track_data  # noqa: E402
from vbt_tpu_torch.tools import gen_docs_pngs as port_docs  # noqa: E402
from vbt_tpu_torch.tools import gen_eval_figs as port_figs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_MODELS = ["efficientdet_lite0_whole", "efficientdet_lite1"]
FPS, HEIGHT, WIDTH = 30.0, 720, 1280


def _golden_track_df(n: int = 240):
    """The plate's track (id 1) and a still one (id 2), as the track CLI
    writes them."""
    data = plate_track_data(n, HEIGHT, WIDTH, fps=FPS)
    still = {"id": [2] * n, "time": data["time"], "x": [0.1] * n, "y": [0.8] * n,
             "dx": [0.0] * n, "dy": [0.0] * n, "norm_plate_height": [0.1] * n,
             "norm_plate_width": [0.05] * n}
    return build_track_df({k: data[k] + still[k] for k in data})


@pytest.fixture(scope="module")
def stand_ins(tmp_path_factory):
    """(reference cache, golden dataframe): paths of the stand-in inputs."""
    root = tmp_path_factory.mktemp("reference")
    ours = pd.read_pickle(os.path.join(REPO, port_figs.OUR_CACHE))
    ref = ours[ours["Model"].isin(REF_MODELS)].iloc[::3].reset_index(drop=True)
    ref_cache = str(root / "eval_detections.pkl.gz")
    ref.to_pickle(ref_cache)
    plot_df = str(root / build_df_filename("001_squat_6reps.mp4", 1,
                                           "efficientdet_lite0_whole.msgpack"))
    _golden_track_df().to_pickle(plot_df)
    return ref_cache, plot_df


@pytest.fixture
def point_at(monkeypatch):
    """Run from the repository root (``OUR_CACHE`` is relative) with both
    sides' reference paths set to ``(ref_cache, plot_df)``."""
    monkeypatch.chdir(REPO)

    def point(ref_cache, plot_df):
        for module in (jax_figs, port_figs):
            monkeypatch.setattr(module, "REF_CACHE", ref_cache)
        for module in (jax_docs, port_docs):
            monkeypatch.setattr(module, "PLOT_DF", plot_df)

    return point


def _invoke(command, out_dir):
    result = click_testing.CliRunner().invoke(command, [f"--{out_dir[0]}", out_dir[1]])
    assert result.exit_code == 0, result.output
    return result.output.replace(out_dir[1], "<dir>").splitlines()


def test_merged_detections_equal_jax(stand_ins, point_at):
    point_at(*stand_ins)
    got = port_figs.merged_detections()
    pd.testing.assert_frame_equal(got, jax_figs.merged_detections(), check_exact=True)
    assert set(got["Model"]) >= {f"ref_{m}" for m in REF_MODELS}


def test_curve_metrics_equal_jax(stand_ins, point_at, tmp_path):
    point_at(*stand_ins)
    df = port_figs.merged_detections()
    for iou in (0.5, 0.75):
        d = df.assign(Label=df["IoU"] > iou)
        got = (port_eval.plot_precision_recall(d.copy(), str(tmp_path), iou, []),
               port_eval.plot_roc(d.copy(), str(tmp_path), iou, []))
        want = (jax_eval.plot_precision_recall(d.copy(), str(tmp_path), iou, []),
                jax_eval.plot_roc(d.copy(), str(tmp_path), iou, []))
        for g, w in zip(got, want):
            assert list(g) == list(w) and len(g) == 8
            for model in w:
                assert g[model] == pytest.approx(w[model], rel=0, abs=1e-12), model


def test_gen_eval_figs_matches_jax(stand_ins, point_at, tmp_path):
    point_at(*stand_ins)
    want_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = _invoke(jax_figs.main, ("fig_dir", want_dir))
    got = _invoke(port_figs.make_command(), ("fig_dir", got_dir))
    assert got == want == ["<dir>: 28 PDFs"]
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))


def test_gen_docs_pngs_matches_jax(stand_ins, point_at, tmp_path):
    point_at(*stand_ins)
    want_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = _invoke(jax_docs.main, ("docs_dir", want_dir))
    got = _invoke(port_docs.make_command(), ("docs_dir", got_dir))
    assert got == want
    listing = ["plot.png", "precision_recall_iou_0.75.png", "roc_iou_0.75.png"]
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir)) == listing


def test_absent_reference_inputs_are_skipped(point_at, tmp_path):
    ref_cache, plot_df = str(tmp_path / "no_cache.pkl.gz"), str(tmp_path / "no_df.pkl.gz")
    point_at(ref_cache, plot_df)
    fig_dir, docs_dir = str(tmp_path / "figs"), str(tmp_path / "docs")
    skip = f"{ref_cache}: absent, drawing {port_figs.OUR_CACHE} alone"
    # 6 models: PR and ROC combined at two IoUs, PR per model at 0.75, ROC at both
    assert _invoke(port_figs.make_command(), ("fig_dir", fig_dir)) == [skip, "<dir>: 22 PDFs"]
    assert not [f for f in os.listdir(fig_dir) if "ref_" in f]
    listing = ["precision_recall_iou_0.75.png", "roc_iou_0.75.png"]
    assert _invoke(port_docs.make_command(), ("docs_dir", docs_dir)) == [
        f"{plot_df}: absent, no plot.png", skip, f"<dir>: {listing}"]
    assert sorted(os.listdir(docs_dir)) == listing
