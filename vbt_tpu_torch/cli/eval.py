"""Evaluate detection models: precision-recall and ROC curves against VOC
ground truth.

Port of ``vbt_tpu.cli.eval`` with the same flags, defaults and cached
detections (``dfs/eval_detections.pkl.gz``, a ``Score/Model/IoU``
dataframe reused unless ``--replace_df``): every test image goes through
the detector at its own size, batch 1, on the card; each image's
detections are matched to its ground truth by an optimal assignment on the
IoU matrix (:func:`match_bboxes`, the port's Jonker-Volgenant solver), and
the curves are drawn from the matched rows.

The IoU matrix is vectorised float64 numpy with the arithmetic of the
reference's scalar ``_iou``, where the JAX package takes it from its C++
``hostops.iou_matrix``. Before the first detection, as in the JAX CLI,
:func:`create_detections_df` probes the card in a deadlined subprocess
(:mod:`vbt_tpu_torch.utils.health`); ``DetectionPipeline`` raises without a
card. click, cv2, pandas, matplotlib, seaborn and sklearn are imported
inside the functions that use them.

Usage: ``python -m vbt_tpu_torch.cli.eval --img_dir data/test
--annotations_dir data/test --fig_dir figs/ models/efficientdet_lite0_whole.msgpack``
"""

from __future__ import annotations

import ast
import glob
import os

import numpy as np

from vbt_tpu_torch.contract.parsers import read_voc_annotations
from vbt_tpu_torch.tracking.assignment import linear_assignment

LABEL = "barbell"


def parse_literal(value: str):
    """A Python literal from the shell (``--score_thresholds "[0.2, 0.5]"``);
    raises ``click.BadParameter`` on anything else."""
    try:
        return ast.literal_eval(value)
    except (ValueError, TypeError, SyntaxError, MemoryError, RecursionError):
        import click

        raise click.BadParameter(value) from None


def scaled_bbox(bbox, src_dim, dst_dim) -> np.ndarray:
    """Scale ``[ymin, xmin, ymax, xmax]`` from src (h, w) to dst (h, w),
    truncated to int like the reference."""
    src_h, src_w = src_dim
    dst_h, dst_w = dst_dim
    factors = np.array([dst_h / float(src_h), dst_w / float(src_w)] * 2)
    return (np.asarray(bbox) * factors).astype(int)


def iou_matrix(gt: np.ndarray, det: np.ndarray) -> np.ndarray:
    """(G, D) float64 IoU of every ground-truth box with every detection,
    the reference's ``_iou(det[j], gt[i])`` element by element: the
    intersection clipped at 0 a side, the union ``area_d + area_g - inter``,
    0 where the union is not positive."""
    gt = np.asarray(gt, np.float64).reshape(-1, 4)[:, None, :]
    det = np.asarray(det, np.float64).reshape(-1, 4)[None, :, :]
    iy1 = np.maximum(det[..., 0], gt[..., 0])
    ix1 = np.maximum(det[..., 1], gt[..., 1])
    iy2 = np.minimum(det[..., 2], gt[..., 2])
    ix2 = np.minimum(det[..., 3], gt[..., 3])
    inter = np.maximum(0.0, iy2 - iy1) * np.maximum(0.0, ix2 - ix1)
    area_d = (det[..., 2] - det[..., 0]) * (det[..., 3] - det[..., 1])
    area_g = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])
    union = area_d + area_g - inter
    return np.divide(inter, union, out=np.zeros_like(inter), where=union > 0)


def match_bboxes(gt_bboxes: np.ndarray, det_bboxes: np.ndarray):
    """Optimal ground-truth to detection matching: the IoU matrix padded to
    a square with zeros, the minimum assignment of ``1 - IoU``, dummy
    detections dropped. Returns ``(gt_idx, det_idx, ious)``; a detection
    left to a dummy ground-truth row keeps its row with IoU 0."""
    n_gt, n_det = len(gt_bboxes), len(det_bboxes)
    iou = iou_matrix(gt_bboxes, det_bboxes)
    if n_det > n_gt:
        iou = np.concatenate([iou, np.zeros((n_det - n_gt, n_det))], axis=0)
    if n_gt > n_det:
        iou = np.concatenate([iou, np.zeros((n_gt, n_gt - n_det))], axis=1)
    pairs = linear_assignment(1 - iou)
    sel = pairs[:, 1] < n_det
    idx_gt, idx_det = pairs[sel, 0], pairs[sel, 1]
    return idx_gt, idx_det, iou[idx_gt, idx_det]


def image_detections(pipeline, img: np.ndarray) -> dict:
    """One uint8 RGB image at its own size, batch 1: the valid boxes in
    integer pixels (:func:`scaled_bbox`) and their float32 scores."""
    h, w, _ = img.shape
    det = pipeline.detect_batch(img[None])
    n = int(det.count[0])
    boxes = det.boxes[0, :n].cpu().numpy().astype(np.float64)
    return {
        "boxes": (np.stack([scaled_bbox(b, (1, 1), (h, w)) for b in boxes]) if n
                  else np.zeros((0, 4), int)),
        "scores": det.scores[0, :n].cpu().numpy().astype(np.float32),
    }


def detection_rows(annotations: dict, detections: dict) -> tuple[list, list, list]:
    """``(scores, models, ious)``: one row a detection of every model on
    every annotated image, in the annotations' order, each with the IoU of
    its matched ground truth. ``detections[model][file]`` is
    :func:`image_detections`' dict."""
    scores, model_col, ious = [], [], []
    for file, gt_bboxes in annotations.items():
        for model, model_detections in detections.items():
            d = model_detections[file]
            _, det_idx, det_ious = match_bboxes(gt_bboxes, d["boxes"])
            for i, di in enumerate(det_idx):
                scores.append(d["scores"][di])
                ious.append(det_ious[i])
                model_col.append(model)
    return scores, model_col, ious


def create_detections_df(models, img_dir, annotations, export_path, device="cuda"):
    """Run every model over the JPGs of ``img_dir`` (detections kept at
    threshold 0), match them against ``annotations`` and pickle the
    ``Score/Model/IoU`` dataframe to ``export_path``."""
    import cv2
    import pandas as pd

    from vbt_tpu_torch.runtime.pipeline import DetectionPipeline
    from vbt_tpu_torch.utils.cache import enable_persistent_cache
    from vbt_tpu_torch.utils.health import require_healthy_device

    # The only path of the CLI that touches the card: fail fast on a wedged
    # one instead of hanging in the first detection.
    enable_persistent_cache()
    require_healthy_device(device, context="eval")

    img_files = sorted(glob.glob(f"{img_dir}/*.jpg"))
    detections = {}
    for m in models:
        pipeline = DetectionPipeline.from_model_arg(m, device=device)
        detections[os.path.basename(m).split(".")[0]] = {
            os.path.basename(f): image_detections(
                pipeline, cv2.cvtColor(cv2.imread(f), cv2.COLOR_BGR2RGB))
            for f in img_files}
    scores, model_col, ious = detection_rows(annotations, detections)
    df = pd.DataFrame({"Score": scores, "Model": model_col, "IoU": ious})
    df.to_pickle(export_path)
    return df


def _decorate(ax, minor):
    """The axes styling both curve figures share."""
    from matplotlib.ticker import MultipleLocator

    ax.set_xlim(0, 1.01)
    ax.set_ylim(0, 1.01)
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)
    if minor[0]:
        ax.xaxis.set_minor_locator(MultipleLocator(minor[0]))
    ax.yaxis.set_minor_locator(MultipleLocator(minor[1]))
    ax.grid(which="major", color="gray", linestyle="-", linewidth=0.5, alpha=0.7)
    ax.grid(which="minor", color="gray", linestyle=":", linewidth=0.5, alpha=0.5)


def plot_precision_recall(df, fig_dir, iou_threshold, score_thresholds=None, fmt="pdf"):
    """PR curves per model with AP annotations; returns ``{model: AP}``."""
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns
    from sklearn.metrics import average_precision_score, precision_recall_curve

    aps, prcs = {}, []
    for m in pd.unique(df["Model"]):
        dfm = df.query("Model == @m")
        precision, recall, thresholds = precision_recall_curve(dfm["Label"], dfm["Score"])
        thresholds = np.concatenate([thresholds, [thresholds[-1]]])
        prcs.append(pd.DataFrame({"Precision": precision, "Recall": recall,
                                  "Threshold": thresholds, "Model": m}))
        aps[m] = average_precision_score(dfm["Label"], dfm["Score"])
    df_prc = pd.concat(prcs, ignore_index=True)

    _, ax = plt.subplots(figsize=(7, 4))
    sns.lineplot(ax=ax, data=df_prc, x="Recall", y="Precision", hue="Model", errorbar=None)
    handles, labels = ax.get_legend_handles_labels()
    for i, model in enumerate(labels):
        labels[i] += f", AP$_{{{iou_threshold * 100:0.0f}}}={aps[model]:.4f}$"
    _decorate(ax, (None, 0.1))
    ax.legend(handles, labels, loc="lower left")
    plt.tight_layout()
    plt.savefig(os.path.join(fig_dir, f"precision_recall_iou_{iou_threshold}.{fmt}"), dpi=300)
    plt.close()

    if score_thresholds:
        colors = _model_colors(handles, labels)
        for m in pd.unique(df["Model"]):
            dfm = df_prc.query("Model == @m")
            _, ax = plt.subplots(figsize=(7, 3))
            sns.lineplot(ax=ax, data=dfm, x="Recall", y="Precision", hue="Model",
                         errorbar=None, palette=[colors[m]])
            h2, l2 = ax.get_legend_handles_labels()
            _decorate(ax, (0.05, 0.05))
            ax.legend(h2, [f"{model}, AP={aps[model]:.4f}" for model in l2], loc="lower left")
            for i, v in enumerate(score_thresholds[::-1]):
                row = dfm.loc[(dfm["Threshold"] - v).abs().idxmin()]
                ax.annotate(f"{row['Threshold']:.4f}", xy=(row["Recall"], row["Precision"]),
                            xycoords="data", xytext=(-50, -(min(i, 3) + 1) * 15),
                            textcoords="offset points",
                            arrowprops=dict(arrowstyle="->", color="k",
                                            connectionstyle="arc3,rad=+0.1", relpos=(1, 1)),
                            fontsize=10)
            plt.tight_layout()
            plt.savefig(os.path.join(fig_dir, f"precision_recall_{m}_iou_{iou_threshold}.pdf"))
            plt.close()
    return aps


def _model_colors(handles, labels):
    """Color per model from the combined figure's legend."""
    return {label.split(",")[0]: handle.get_color() for handle, label in zip(handles, labels)}


def plot_roc(df, fig_dir, iou_threshold, score_thresholds=None, fmt="pdf"):
    """ROC curves per model with AUC annotations; returns ``{model: AUC}``."""
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns
    from sklearn.metrics import roc_auc_score, roc_curve

    rocs, aucs = [], {}
    for m in pd.unique(df["Model"]):
        dfm = df.query("Model == @m")
        fpr, tpr, thresholds = roc_curve(dfm["Label"], dfm["Score"])
        rocs.append(pd.DataFrame({"FP Rate": fpr, "TP Rate": tpr, "Threshold": thresholds,
                                  "Model": m}))
        aucs[m] = roc_auc_score(dfm["Label"], dfm["Score"])
    df_roc = pd.concat(rocs, ignore_index=True)

    _, ax = plt.subplots(figsize=(7, 4))
    sns.lineplot(ax=ax, data=df_roc, x="FP Rate", y="TP Rate", hue="Model", errorbar=None)
    handles, labels = ax.get_legend_handles_labels()
    for i, model in enumerate(labels):
        labels[i] += f", AUC={aucs[model]:.4f}"
    _decorate(ax, (0.1, 0.1))
    ax.legend(handles, labels, loc="lower right")
    plt.tight_layout()
    plt.savefig(os.path.join(fig_dir, f"roc_iou_{iou_threshold}.{fmt}"), dpi=300)
    plt.close()

    if score_thresholds:
        colors = _model_colors(handles, labels)
        for m in pd.unique(df["Model"]):
            dfm = df_roc.query("Model == @m")
            _, ax = plt.subplots(figsize=(7, 3))
            sns.lineplot(ax=ax, data=dfm, x="FP Rate", y="TP Rate", hue="Model",
                         errorbar=None, palette=[colors[m]])
            h2, l2 = ax.get_legend_handles_labels()
            _decorate(ax, (0.05, 0.05))
            ax.legend(h2, [f"{model}, AUC={aucs[model]:.4f}" for model in l2], loc="lower right")
            for i, v in enumerate(score_thresholds):
                row = dfm.loc[(dfm["Threshold"] - v).abs().idxmin()]
                ax.annotate(f"{row['Threshold']:.4f}", xy=(row["FP Rate"], row["TP Rate"]),
                            xycoords="data",
                            xytext=((len(score_thresholds) - i) * 8, -(i + 1) * 15),
                            textcoords="offset points",
                            arrowprops=dict(arrowstyle="->", color="k",
                                            connectionstyle="arc3,rad=-0.1", relpos=(0, 1)),
                            fontsize=10)
            plt.tight_layout()
            plt.savefig(os.path.join(fig_dir, f"roc_{m}_iou_{iou_threshold}.pdf"))
            plt.close()
    return aucs


def run(models, img_dir, annotations_dir, fig_dir, iou_threshold, detections_df, replace_df,
        score_thresholds):
    """The body of the CLI, callable without click."""
    import pandas as pd
    import seaborn as sns

    sns.set_theme(context="paper", style="ticks")
    annotations = read_voc_annotations(annotations_dir, label=LABEL)
    if not os.path.exists(detections_df) or replace_df:
        print(f"Creating dataframe '{detections_df}'.")
        os.makedirs(os.path.dirname(detections_df) or ".", exist_ok=True)
        df = create_detections_df(models, img_dir, annotations, detections_df)
    else:
        print(f"Loading dataframe '{detections_df}'.")
        df = pd.read_pickle(detections_df)
    df["Label"] = df["IoU"] > iou_threshold
    if fig_dir is not None:
        os.makedirs(fig_dir, exist_ok=True)
        plot_precision_recall(df.copy(), fig_dir, iou_threshold, score_thresholds)
        plot_roc(df.copy(), fig_dir, iou_threshold, score_thresholds)
    return df


def make_command():
    """Build the click command (click is imported here, not at import)."""
    import click

    class PythonLiteralOption(click.Option):
        """An option whose value is a Python literal (a list of thresholds)."""

        def type_cast_value(self, ctx, value):
            return parse_literal(value)

    @click.command()
    @click.argument("models", type=str, nargs=-1)
    @click.option("--img_dir", default="data/test", show_default=True,
                  help="Directory containing the JPG test images.")
    @click.option("--annotations_dir", default="data/test", show_default=True,
                  help="Directory containing the XML annotation files.")
    @click.option("--fig_dir", default=None, show_default=True,
                  help="Directory for saving the figures. If not set the figures won't be saved.")
    @click.option("--iou_threshold", default=0.5, type=float, show_default=True,
                  help="Intersection over union threshold to label detections as correct or not when calculated against the ground truth bounding boxes.")
    @click.option("--threads", default=4, show_default=True,
                  help="Kept for CLI compatibility; the card's pipeline ignores it.")
    @click.option("--detections_df", default="dfs/eval_detections.pkl.gz", show_default=True,
                  help="Path for storing/reading the detection results dataframe.")
    @click.option("--replace_df", is_flag=True, show_default=True,
                  help="If exists, replace the detections dataframe.")
    @click.option("--score_thresholds", default="[]", cls=PythonLiteralOption, show_default=True,
                  help='List of score thresholds to plot on the ROC curves, e.g. "[0.2, 0.5]".')
    def command(models, img_dir, annotations_dir, fig_dir, iou_threshold, threads,
                detections_df, replace_df, score_thresholds):
        """Plot Precision-Recall and ROC curves for the specified models."""
        del threads
        run(models, img_dir, annotations_dir, fig_dir, iou_threshold, detections_df,
            replace_df, score_thresholds)

    return command


def main(args=None, standalone_mode: bool = True):
    """Console entry point (``vbt-torch-eval``)."""
    return make_command().main(args=args, standalone_mode=standalone_mode)


if __name__ == "__main__":
    main()
