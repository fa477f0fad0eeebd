"""Segmentation metrics: a confusion hist kept on the device, and scores
(counterpart of excel_tpu/utils/metrics.py)."""
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
