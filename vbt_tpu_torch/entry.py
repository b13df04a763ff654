"""Entry points of the port: one detection step, and a dry run over devices.

Port of the JAX package's ``__graft_entry__.py``:

- :func:`entry` returns ``(fn, (model, frames))``: ``fn`` runs one batched
  detection step of EfficientDet-Lite0, float32 (JAX's default dtype):
  ``preprocess_frames``, the forward and the class-aware
  ``detection_postprocess`` (the XLA path of ``__graft_entry__.py:14-38``,
  not the NMS kernel), on a model holding
  :meth:`~vbt_tpu_torch.runtime.pipeline.DetectionPipeline.init_variables`
  weights and zero frames (4, 720, 1280, 3) uint8;
- :func:`dryrun_multichip` runs the three checks of
  ``__graft_entry__.py:172-244`` over ``n`` devices: one data-parallel
  ``Trainer(mesh=)`` step at 128 px on a global batch of ``n``, an image a
  device, with the BatchNorm statistics of the global batch (what GSPMD
  makes of JAX's jitted step on the sharded batch); batched inference
  through the same trainer's ``eval_forward``, a shard of the batch on each
  device, equal to the one-device ``eval_forward``; and the time-sharded
  tracker relay against one ``track_video``.

``python -m vbt_tpu_torch.entry [--device cpu] [--devices D,D,...]`` runs
both and prints ``entry ok`` and ``dryrun ok``; the dry run takes the
devices named (``cuda:0,cuda:0`` runs it over one card twice), by default
every card, or ``cpu,cpu`` with ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

SIZE = 128  # the dry run's train step: tiny but valid (P7 is 1x1)
INFER_TOL = 1e-5  # sharded inference against one device, absolute and relative
BOX_TOL = 1e-6  # the relay's boxes against one scan


def entry(device=None):
    """``(fn, (model, frames))``: ``fn(model, frames)`` -> Detections of one
    batched detection step (module docstring), on ``device`` (the card
    unless the caller asks for the CPU)."""
    from vbt_tpu_torch.models import EfficientDet, get_model_spec
    from vbt_tpu_torch.models.anchors import generate_anchors
    from vbt_tpu_torch.ops.postprocess import detection_postprocess
    from vbt_tpu_torch.ops.preprocess import preprocess_frames
    from vbt_tpu_torch.runtime.checkpoint import load_into
    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
    from vbt_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda" if device is None else device)
    spec = get_model_spec("efficientdet_lite0")
    model = load_into(EfficientDet(spec), DetectionPipeline.init_variables(spec)).eval().to(dev)
    anchors = torch.from_numpy(generate_anchors(spec.anchor_config)).to(dev)

    @torch.inference_mode()
    def fn(model, frames):
        images = preprocess_frames(frames, spec.input_size)
        deltas, logits = model(images)
        return detection_postprocess(deltas, logits, anchors, input_size=spec.input_size)

    frames = torch.zeros((4, 720, 1280, 3), dtype=torch.uint8, device=dev)
    return fn, (model, frames)


def _train_batch(b: int, device) -> dict:
    """JAX's dry-run batch: uniform images in [-1, 1] from seed 0, one GT
    box a frame; NCHW for the port's trainer."""
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, size=(b, SIZE, SIZE, 3)).astype(np.float32)
    return {
        "images": torch.from_numpy(images).permute(0, 3, 1, 2).contiguous().to(device),
        "gt_boxes": torch.tensor([[[30.0, 30.0, 90.0, 90.0]]]).repeat(b, 1, 1).to(device),
        "gt_valid": torch.ones((b, 1), dtype=torch.bool, device=device),
    }


def _relay_inputs(t_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """JAX's dry-run detections: one plate on a sine, jittered from seed 1."""
    rng = np.random.default_rng(1)
    dets = np.zeros((t_frames, 2, 6))
    valid = np.zeros((t_frames, 2), bool)
    for f in range(t_frames):
        y0 = 0.3 + 0.2 * np.sin(f / 7.0)
        dets[f, 0] = [0.2, y0, 0.4, y0 + 0.15, 0.9, 0]
        dets[f, 0, :4] += rng.normal(0, 0.003, 4)
        valid[f, 0] = True
    return dets, valid


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The dry run over ``make_mesh(n_devices)`` (the cards), or over
    ``devices`` as given (the CPU lane passes ``[cpu] * n``); raises on a
    failed check."""
    from vbt_tpu_torch.models import get_model_spec
    from vbt_tpu_torch.parallel.mesh import make_mesh
    from vbt_tpu_torch.parallel.time_shard import track_video_time_sharded
    from vbt_tpu_torch.tracking.scan import ScanTrackerConfig, track_video
    from vbt_tpu_torch.train.train_step import Trainer

    mesh = make_mesh(n_devices, devices)
    n = len(mesh)
    first = mesh[0]
    spec = get_model_spec("efficientdet_lite0")

    # 1. One data-parallel train step over the global batch of n.
    kw = dict(base_lr=0.01, total_steps=10, warmup_steps=1, input_size=SIZE)
    trainer = Trainer(spec, mesh=mesh, **kw)
    state = trainer.init_state(seed=0)
    batch = _train_batch(n, first)
    new_state, metrics = trainer.train_step(state, batch)
    if new_state.step != 1 or not np.isfinite(float(metrics["loss"])):
        raise AssertionError(f"train step: step {new_state.step}, loss {metrics['loss']}")

    # 2. Batched inference, a shard of the batch on each device.
    sharded = trainer.eval_forward(new_state, batch["images"])
    want = Trainer(spec, device=first, **kw).eval_forward(new_state, batch["images"])
    for got, ref, name in zip(sharded, want, ("deltas", "logits")):
        if got.shape != ref.shape:
            raise AssertionError(f"sharded {name}: shape {tuple(got.shape)}, want "
                                 f"{tuple(ref.shape)}")
        if not torch.allclose(got, ref, atol=INFER_TOL, rtol=INFER_TOL):
            raise AssertionError(f"sharded {name} differ from one device's by up to "
                                 f"{(got - ref).abs().max().item():.3g}")

    # 3. The frame axis over the devices, the tracker carry relayed.
    cfg = ScanTrackerConfig.ocsort(max_age=30, iou_threshold=0.1, asso="diou", max_tracks=8)
    dets, valid = _relay_inputs(4 * n)
    dtype = torch.float32 if first.type == "cuda" else torch.float64  # K3 takes float32
    dets_t = torch.from_numpy(dets).to(dtype)
    sharded = track_video_time_sharded(cfg, dets_t, torch.from_numpy(valid), mesh)
    single = track_video(cfg, dets_t.to(first), torch.from_numpy(valid).to(first))
    if not torch.equal(single.track_id.cpu(), sharded.track_id):
        raise AssertionError("relay: track ids differ from one scan's")
    if not torch.allclose(single.box.cpu(), sharded.box, atol=BOX_TOL, rtol=0):
        raise AssertionError("relay: boxes differ from one scan's")


def main(argv=None) -> None:
    from vbt_tpu_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(prog="python -m vbt_tpu_torch.entry",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--devices", default=None,
                        help="comma-separated devices of the dry run")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    fn, fn_args = entry(dev)
    out = fn(*fn_args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print("entry ok:", {k: tuple(v.shape) for k, v in out._asdict().items()})
    if args.devices:
        devices = [resolve_device(d) for d in args.devices.split(",")]
        dryrun_multichip(len(devices), devices)
    elif dev.type == "cuda":
        dryrun_multichip(torch.cuda.device_count())
    else:
        dryrun_multichip(2, [dev] * 2)
    print("dryrun ok")


if __name__ == "__main__":
    main()
