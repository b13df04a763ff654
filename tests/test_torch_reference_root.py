"""The port's one reference data root (``vbt_tpu_torch/tools/_reference.py``)
on the CPU.

The JAX package's tools read the reference project at its absolute
location: the selection tools default ``--data_dir`` to its ``data/``,
``turbo_check`` and ``prefilter_check`` read every JPEG of its
``data/test/``. The port's read ``reference/`` under the working
directory. Here a VOC tree
written by ``io/synthetic.py::write_voc`` is laid out as
``reference/data/{train,test}`` under a temporary directory and the tests
``chdir`` into it:

- every tool's default, and the end-to-end and figure tools' constants, lie
  under ``reference/``;
- the selection tools' bodies, called with no ``data_dir``, read that tree;
- the checks' loader equals JAX's own statements (``tools/turbo_check.py``
  and ``tools/prefilter_check.py``, from the ``files`` assignment through
  the loop that fills ``imgs``, run with ``glob`` pointed at the tree) bit
  for bit, uint8, with the file count;
- both checks' ``main`` with ``--device cpu`` exit 0 with and without the
  tree, and their ``images:`` line names the count and the source (the
  directory, or ``synthetic`` after the fallback line).

lite0 only, torch on one thread (``tests/torch_threads.py``); the speed
half of the checks runs at B = 2 with its loops cut, as in
``tests/test_torch_measure_tools.py``.
"""

import ast
import glob
import inspect
import io
import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from torch_threads import one_torch_thread  # noqa: E402, F401

from tools import prefilter_check as jax_prefilter  # noqa: E402
from tools import turbo_check as jax_turbo  # noqa: E402
from vbt_tpu_torch.io.synthetic import write_voc  # noqa: E402
from vbt_tpu_torch.tools import (_reference, ckpt_soup, ckpt_sweep,  # noqa: E402
                                 gen_docs_pngs, gen_eval_figs, int8_delta, make_demo_video,
                                 prefilter_check, turbo_check)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models", "efficientdet_lite0_whole.msgpack")
ARCH = "efficientdet_lite0"
TEST_SIZES = ((96, 128), (128, 96), (120, 160))  # mixed sizes, 2 images each
N_TEST = 2 * len(TEST_SIZES)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A directory holding ``reference/data/{train,test}`` (write_voc)."""
    root = tmp_path_factory.mktemp("checkout")
    for part, sizes in (("train", TEST_SIZES[:1]), ("test", TEST_SIZES)):
        d = root / _reference.DATA_DIR / part
        d.mkdir(parents=True)
        write_voc(str(d), sizes, n=2)
    return root


def test_one_root():
    assert _reference.ROOT == "reference"
    assert _reference.DATA_DIR == "reference/data"
    assert _reference.TEST_DIR == "reference/data/test"
    assert _reference.DFS_DIR == "reference/dfs"


@pytest.mark.parametrize("tool,fn", [(ckpt_sweep, "sweep"), (ckpt_soup, "soup"),
                                     (int8_delta, "int8_delta")])
def test_selection_defaults(tool, fn):
    """The click option and the body's default: ``reference/data``, where
    JAX's tools default to the reference's ``data/`` by its absolute path."""
    assert tool.DEFAULT_DATA_DIR == _reference.DATA_DIR == "reference/data"
    (option,) = [p for p in tool.make_command().params if p.name == "data_dir"]
    assert option.default == "reference/data"
    assert inspect.signature(getattr(tool, fn)).parameters["data_dir"].default == "reference/data"


def test_end_to_end_and_figure_constants():
    assert make_demo_video.DATA == _reference.TEST_DIR
    assert gen_eval_figs.REF_CACHE == os.path.join(_reference.DFS_DIR, "eval_detections.pkl.gz")
    assert os.path.dirname(gen_docs_pngs.PLOT_DF) == _reference.DFS_DIR


def _jax_loader(module, root, size: int) -> np.ndarray:
    """JAX's statements of ``module.main`` from the ``files`` assignment to
    the one before ``frames``, with the absolute reference location of its
    glob mapped to ``root/reference``; the ``imgs`` they fill, stacked."""
    fn = ast.parse(inspect.getsource(module.main)).body[0]
    targets = [getattr(getattr(s, "targets", [None])[0], "id", None) for s in fn.body]
    body = fn.body[targets.index("files"):targets.index("frames")]
    def under_root(pattern):
        assert os.path.isabs(pattern)
        return glob.glob(str(root / pattern[pattern.index(_reference.ROOT + os.sep):]))

    shim = types.SimpleNamespace(glob=under_root)
    ns = {**vars(module), "glob": shim, "cv2": cv2, "size": size}
    exec(compile(ast.Module(body=body, type_ignores=[]), module.__file__, "exec"), ns)
    assert len(ns["files"]) == N_TEST
    return np.stack(ns["imgs"])


@pytest.mark.parametrize("module", [jax_turbo, jax_prefilter], ids=["turbo", "prefilter"])
def test_loader_matches_jax(tree, module, monkeypatch):
    monkeypatch.chdir(tree)
    images, n = turbo_check.test_images(64)
    want = _jax_loader(module, tree, 64)
    assert n == N_TEST and images.dtype == np.uint8 and images.shape == (N_TEST, 64, 64, 3)
    np.testing.assert_array_equal(images, want)


def test_loader_without_images(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    images, n = turbo_check.test_images(64)
    assert n == 0 and images.shape == (0, 64, 64, 3) and images.dtype == np.uint8


def _cut_loops(monkeypatch):
    monkeypatch.setattr(turbo_check, "N_SHORT", 1)
    monkeypatch.setattr(turbo_check, "N_LONG", 3)
    monkeypatch.setattr(turbo_check, "TRIALS", 1)
    monkeypatch.setattr(prefilter_check, "TRIALS", 1)


@pytest.mark.parametrize("with_tree", [True, False], ids=["tree", "fallback"])
@pytest.mark.parametrize("tool", [turbo_check, prefilter_check], ids=["turbo", "prefilter"])
def test_check_reads_the_tree(tool, with_tree, tree, tmp_path, monkeypatch, capsys):
    """From a directory holding the tree, every test image; from one
    without it, the fallback line and ``--n_images`` synthetic plates."""
    _cut_loops(monkeypatch)
    monkeypatch.chdir(tree if with_tree else tmp_path)
    assert tool.main(["--n_images", "4", "--batches", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    fallback = f"{_reference.TEST_DIR}: no *.jpg, the numerics run on 4 synthetic plate images"
    assert (fallback in lines) != with_tree
    n, source = (N_TEST, _reference.TEST_DIR) if with_tree else (4, "synthetic")
    (images,) = [line for line in lines if line.startswith("images: ")]
    assert images.startswith(f"images: {n} ({source})")
    if tool is turbo_check:
        (record,) = [json.loads(line[len("JSON: "):]) for line in lines
                     if line.startswith("JSON: ")]
        assert record["source"] == source and record["images"] == n


def test_selection_tools_read_the_tree(tree, monkeypatch):
    """``ckpt_sweep``, ``ckpt_soup`` and ``int8_delta`` with no ``data_dir``
    evaluate on the tree's ``test/`` and calibrate on its ``train/``."""
    from vbt_tpu_torch.runtime.checkpoint import save_train_checkpoint

    monkeypatch.chdir(tree)
    ckpt = tree / "ckpt"
    _, template = ckpt_sweep.selection_trainer(ARCH, "cpu")
    save_train_checkpoint(str(ckpt), 1, template)
    out = io.StringIO()
    swept = ckpt_sweep.sweep(ARCH, str(ckpt), device="cpu", out=out)
    assert [(s, t) for s, t, _ in swept] == [(1, "raw"), (1, "ema")]
    log = tree / "sweep.txt"
    log.write_text(out.getvalue())
    stream = io.StringIO()
    _, members, _ = ckpt_soup.soup(ARCH, str(ckpt), str(log), top_k=1, device="cpu",
                                   stream=stream)
    assert len(members) == 1 and members[0][0] == 1
    assert "final soup (1 members" in stream.getvalue()
    out, err = io.StringIO(), io.StringIO()
    code, m_float, m_int8 = int8_delta.int8_delta(CKPT, calib_n=2, device="cpu", out=out,
                                                  err=err)
    assert out.getvalue().startswith("calib set (2): plate_96x128_0.jpg plate_96x128_1.jpg")
    assert m_float["AP50"] > 0.5  # the shipped lite0 finds the plates of test/
    assert code == int(m_int8["AP75"] - m_float["AP75"] < -0.01)
