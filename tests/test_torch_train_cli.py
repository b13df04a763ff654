"""``vbt-torch-train`` and its helpers on the CPU, on a VOC directory the
test writes (``io.synthetic.write_voc``: six synthetic plate images at
three sizes in each of ``train``, ``valid`` and ``test``).

Held: a short ``train_model`` run (steps, the per-epoch ``val_loss`` line);
heads-only freezing the donor's backbone and BiFPN bit for bit; a missing
donor raising before the model is built; ``--init_from`` at lr 0 keeping
the donor's weights; ``--resume`` continuing from the latest checkpoint;
the CLI body exporting a model the JAX ``load_params`` reads and a log
``parse_logs`` reads; ``split_files`` equal to JAX's for one seed; the
three commands' flags equal to the JAX CLIs' (``CliRunner``); and a CUDA
request without a card raising.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402, F401

from click.testing import CliRunner  # noqa: E402

from vbt_tpu.cli import data_prep as jdp  # noqa: E402
from vbt_tpu.cli import train as jtrain  # noqa: E402
from vbt_tpu.cli import training_plot as jplot  # noqa: E402
from vbt_tpu_torch.cli import data_prep, training_plot  # noqa: E402
from vbt_tpu_torch.cli import train as cli  # noqa: E402
from vbt_tpu_torch.io.synthetic import write_voc  # noqa: E402
from vbt_tpu_torch.models import get_model_spec  # noqa: E402
from vbt_tpu_torch.runtime.checkpoint import save_params  # noqa: E402
from vbt_tpu_torch.train.train_step import Trainer  # noqa: E402

ARCH = "efficientdet_lite0"
SIZE = 64  # training input; evaluation runs at the spec's 320
VOC_SIZES = ((240, 320), (360, 480), (288, 512))  # (h, w), two images each


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc_data")
    for part in ("train", "valid", "test"):
        (root / part).mkdir()
        write_voc(str(root / part), VOC_SIZES)
    return str(root)


def _train(voc, export_dir, **kw):
    logs = []
    args = dict(epochs=2, batch_size=2, train_whole_model=True, base_lr=0.01, max_steps=2,
                log_fn=logs.append, input_size=SIZE, device="cpu")
    args.update(kw)
    trainer, state, val_losses = cli.train_model(ARCH, voc, str(export_dir), **args)
    return trainer, state, val_losses, logs


def _donor(path, seed):
    trainer = Trainer(get_model_spec(ARCH), total_steps=10, warmup_steps=1, input_size=SIZE,
                      device="cpu")
    variables = trainer.variables(trainer.init_state(seed=seed))
    save_params(str(path), variables)
    return variables


def test_train_model_smoke(voc, tmp_path):
    _, state, val_losses, logs = _train(voc, tmp_path, max_steps=4)  # 3 steps an epoch
    assert state.step == 4 and state.opt_state.count == 4
    assert len(val_losses) == 2 and all(np.isfinite(val_losses))
    lines = [line for line in logs if re.search(r"loss: \d+\.\d+ - val_loss: \d+\.\d+", line)]
    assert len(lines) == 2 and lines[0].startswith("Epoch 1/2")


def test_heads_only_freezes_the_donor(voc, tmp_path):
    donor = _donor(tmp_path / f"{ARCH}_whole.msgpack", seed=7)
    trainer, state, _, logs = _train(voc, tmp_path, epochs=1, train_whole_model=False)
    assert any("Heads-only" in line and str(tmp_path) in line for line in logs)
    assert trainer.freeze_top_keys == ("backbone", "fpn")
    got = trainer.variables(state)
    for k, v in donor.items():
        if k.split(".")[0] in ("backbone", "fpn"):
            assert torch.equal(got[k], v), k
    own = trainer.variables(trainer.init_state(seed=0))
    assert any(not torch.equal(got[k], own[k]) for k in own if k.startswith("class_net"))


def test_heads_only_missing_donor_raises_before_init(voc, tmp_path, monkeypatch):
    real_isfile = os.path.isfile
    monkeypatch.setattr(os.path, "isfile",  # hide the shipped donors
                        lambda p: False if str(p).endswith("_whole.msgpack") else real_isfile(p))

    def no_init(*a, **k):
        raise AssertionError("the model was built before the donor was found")

    monkeypatch.setattr(cli, "Trainer", no_init)
    with pytest.raises(FileNotFoundError, match="donor"):
        _train(voc, tmp_path, train_whole_model=False)


def test_init_from_at_zero_lr_keeps_the_donor(voc, tmp_path):
    donor = _donor(tmp_path / "soup.msgpack", seed=11)
    trainer, state, _, logs = _train(voc, tmp_path, epochs=1, base_lr=0.0, max_steps=1,
                                     init_from=str(tmp_path / "soup.msgpack"))
    assert any("Warm start" in line for line in logs)
    got = trainer.variables(state)
    for k in trainer.param_keys:
        assert torch.equal(got[k], donor[k]), k


def test_resume_continues_from_the_latest_checkpoint(voc, tmp_path):
    ckpt = tmp_path / "ckpt"
    _, first, _, _ = _train(voc, tmp_path, epochs=1, max_steps=None, checkpoint_dir=str(ckpt),
                            checkpoint_every=1)
    assert first.step == 3 and (ckpt / "step_00000001.msgpack").exists()
    _, state, val_losses, logs = _train(voc, tmp_path, epochs=2, max_steps=None,
                                        checkpoint_dir=str(ckpt), checkpoint_every=1, resume=True)
    assert any("Resumed from checkpoint at epoch 1" in line for line in logs)
    assert state.step == 6 and len(val_losses) == 1
    assert (ckpt / "step_00000002.msgpack").exists()


def test_cli_body_exports_and_logs(voc, tmp_path):
    """run(): train one step at the spec's input size, evaluate raw and EMA
    through the pipeline, export the better, write the log."""
    from vbt_tpu.runtime.checkpoint import load_params as jax_load_params
    from vbt_tpu.train.train_step import Trainer as JaxTrainer
    from vbt_tpu.models import get_model_spec as jax_spec

    results = cli.run(voc, str(tmp_path), ARCH, 1, 2, True, 0.01, 0, 1, None, 0, False, 0.5, None,
                      device="cpu")
    assert set(results) == {"raw", "ema"} and {"AP", "AP50", "AP75"} <= set(results["raw"])
    name = f"{ARCH}_whole"
    losses = training_plot.parse_logs(str(tmp_path))
    assert losses == jplot.parse_logs(str(tmp_path))
    assert len(losses[name]) == 1 and np.isfinite(losses[name][0])
    jstate = JaxTrainer(jax_spec(ARCH), total_steps=10, warmup_steps=1).init_state(seed=0)
    loaded = jax_load_params(str(tmp_path / f"{name}.msgpack"),
                             {"params": jstate.params, "batch_stats": jstate.batch_stats})
    assert loaded["params"]["backbone"]["stem"]["kernel"].dtype == np.float32


def test_voc_dataset_and_host_batches_match_jax(voc):
    """load_voc_dataset, raw_batches and the host lane's cv2 flip and jitter
    equal the JAX package's for the same seed (the same numpy and cv2 calls)."""
    from vbt_tpu.train import data as jdata
    from vbt_tpu_torch.train import data

    path = os.path.join(voc, "train")
    got, want = data.load_voc_dataset(path, SIZE), jdata.load_voc_dataset(path, SIZE)
    assert got.names == want.names and len(got) == 6
    for name in ("images", "boxes", "valid"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for drop in (True, False):
        pairs = zip(data.raw_batches(got, 4, np.random.default_rng(1), drop),
                    jdata.raw_batches(want, 4, np.random.default_rng(1), drop))
        assert all(all(np.array_equal(x, y) for x, y in zip(a, b)) for a, b in pairs)
    for seed in (0, 1, 2):
        port = list(data.batches(got, 4, np.random.default_rng(seed), drop_remainder=False))
        ref = list(jdata.batches(want, 4, np.random.default_rng(seed), drop_remainder=False))
        assert len(port) == len(ref) == 2
        for a, b in zip(port, ref):
            assert a.keys() == b.keys()
            assert all(np.array_equal(a[k], b[k]) for k in a)


def test_split_files_matches_jax():
    files = [f"img_{i:03d}" for i in range(41)]
    for seed in (0, 5):
        got = data_prep.split_files(files, np.random.default_rng(seed))
        want = jdp.split_files(files, np.random.default_rng(seed))
        assert got == want


def test_data_prep_copies_pairs(tmp_path):
    ann, img = tmp_path / "Annotations", tmp_path / "images"
    ann.mkdir()
    img.mkdir()
    for i in range(20):
        (ann / f"f{i}.xml").write_text("<annotation/>")
        (img / f"f{i}.jpg").write_bytes(b"jpg")
    parts = data_prep.run(str(ann), str(img), str(tmp_path / "data"), 3)
    assert {k: len(v) for k, v in parts.items()} == {"train": 17, "test": 1, "valid": 2}
    for part, stems in parts.items():
        assert sorted(os.listdir(tmp_path / "data" / part)) == sorted(
            f"{s}{e}" for s in stems for e in (".jpg", ".xml"))


@pytest.mark.parametrize("port,jax_main", [(cli, jtrain.main), (data_prep, jdp.main),
                                           (training_plot, jplot.main)],
                         ids=["train", "data_prep", "training_plot"])
def test_cli_flags_match_jax(port, jax_main):
    command = port.make_command()
    def names(c):
        return [(p.name, p.default, getattr(p, "is_flag", False)) for p in c.params]

    # The train CLI's one option beyond JAX's: the span report at the end.
    extra = [("timing", False, True)] if port is cli else []
    assert names(command) == names(jax_main) + extra
    out = CliRunner().invoke(command, ["--help"])
    assert out.exit_code == 0
    assert all(f"--{p.name}" in out.output for p in command.params if p.name != "train_whole_model")


def test_cuda_request_without_card_raises(voc, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the no-card refusal is what is tested")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.train_model(ARCH, voc, str(tmp_path), 1, 4, True, max_steps=1, input_size=SIZE)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(get_model_spec(ARCH))
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(get_model_spec(ARCH), dtype=torch.bfloat16)
    # bfloat16 is a compute dtype now (tests/test_torch_train_bf16.py); a
    # dtype the JAX Trainer has no counterpart of is refused.
    with pytest.raises(ValueError, match="float16"):
        Trainer(get_model_spec(ARCH), dtype=torch.float16, device="cpu")
