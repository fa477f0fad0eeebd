"""Segmentation metrics: a confusion hist kept on the device (and its host
form for saved predictions), scores and their table (counterpart of
excel_tpu/utils/metrics.py)."""
from __future__ import annotations

import numpy as np
import torch


def init_hist(num_classes: int, device="cpu") -> torch.Tensor:
    return torch.zeros((num_classes, num_classes), dtype=torch.int64,
                       device=device)


def update_hist(hist: torch.Tensor, label_true: torch.Tensor,
                label_pred: torch.Tensor, num_classes: int) -> torch.Tensor:
    """hist [C, C] + counts of (true, pred) pairs over the pixels whose true
    and predicted labels both lie in [0, C) (255-ignore pixels drop out)."""
    lt = label_true.reshape(-1).long()
    lp = label_pred.reshape(-1).long()
    valid = (lt >= 0) & (lt < num_classes) & (lp >= 0) & (lp < num_classes)
    counts = torch.bincount(lt[valid] * num_classes + lp[valid],
                            minlength=num_classes * num_classes)
    return hist + counts.reshape(num_classes, num_classes)


def update_hist_pseudo(hist: torch.Tensor, label_true: torch.Tensor,
                       label_pred: torch.Tensor, num_classes: int,
                       ignore_index: int = 255) -> torch.Tensor:
    """`update_hist` for pseudo-label scores: the pixels the pseudo-label
    marks `ignore_index` are dropped from the ground truth too."""
    lp = label_pred.reshape(-1).long()
    lt = label_true.reshape(-1).long()
    ignored = lp == ignore_index
    lt = torch.where(ignored, ignore_index, lt)
    lp = torch.where(ignored, 0, lp)
    return update_hist(hist, lt, lp, num_classes)


def update_hist_np(hist: np.ndarray, label_true: np.ndarray,
                   label_pred: np.ndarray, num_classes: int) -> np.ndarray:
    """`update_hist` on the host, in place on an int64 [C, C] numpy hist,
    for predictions that are host arrays already (read back from files).
    A prediction outside [0, num_classes) on a scored pixel raises."""
    lt = np.asarray(label_true).reshape(-1).astype(np.int64)
    lp = np.asarray(label_pred).reshape(-1).astype(np.int64)
    valid = (lt >= 0) & (lt < num_classes)
    lpv = lp[valid]
    if lpv.size and not (0 <= int(lpv.min())
                         and int(lpv.max()) < num_classes):
        raise ValueError(
            f"label_pred range [{lpv.min()}, {lpv.max()}] outside "
            f"num_classes={num_classes}: config/prediction mismatch?")
    idx = lt[valid] * num_classes + lpv
    hist += np.bincount(idx, minlength=num_classes ** 2).reshape(
        num_classes, num_classes)
    return hist


def scores_from_hist(hist) -> dict:
    """pAcc/mAcc/mIoU (over classes present in GT), per-class
    iou/precision/recall/confusion-ratio."""
    if isinstance(hist, torch.Tensor):
        hist = hist.cpu().numpy()
    hist = np.asarray(hist, np.float64)
    num_classes = hist.shape[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0)
                              - np.diag(hist))
        valid = hist.sum(axis=1) > 0
        mean_iu = np.nanmean(iu[valid])
        tp = np.diag(hist)
        fn = hist.sum(axis=1) - tp
        fp = hist.sum(axis=0) - tp
        cr = fp / tp
        precision = tp / (tp + fp)
        recall = tp / (tp + fn)
    rng = range(num_classes)
    return {"pAcc": acc, "mAcc": acc_cls, "miou": mean_iu,
            "iou": dict(zip(rng, iu)),
            "confusion": dict(zip(rng, cr)),
            "precision": dict(zip(rng, precision)),
            "recall": dict(zip(rng, recall))}


def format_metrics_table(score: dict, class_names: list[str],
                         metrics=("iou",)) -> str:
    """Per-class metric table in percent, one row a class and a last mIoU
    row."""
    cols = ["class"] + list(metrics)
    rows = []
    for i, name in enumerate(class_names):
        rows.append([name] + [f"{100 * score[m][i]:.2f}" for m in metrics])
    rows.append(["mIoU"] + [f"{100 * score['miou']:.2f}"] +
                [""] * (len(metrics) - 1))
    widths = [max(len(str(r[c])) for r in [cols] + rows)
              for c in range(len(cols))]
    lines = ["  ".join(str(v).ljust(w) for v, w in zip(r, widths))
             for r in [cols] + rows]
    return "\n".join(lines)
