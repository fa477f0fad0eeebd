"""Training losses (counterpart of excel_tpu/models/losses.py).

Under a process group each rank holds its rows of the global batch, and
the JAX package's divisors (pixel and pair counts over the whole batch its
mesh spans) are summed over the ranks before the `+ eps`, without
gradient: a rank's loss is then its share of the global loss, and the
ranks' losses sum to it. Without a group the sums are the local ones."""
from __future__ import annotations

import torch

from ..parallel.distributed import group_sum


def _ce_sum(logits: torch.Tensor, labels: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """Sum of per-pixel cross-entropy over the valid pixels. logits
    [B, C, H, W], labels [B, H, W] int, valid [B, H, W] bool. The label's
    log-probability is picked by a class compare-select, as in the JAX
    package (labels outside [0, C) pick 0)."""
    logp = torch.log_softmax(logits.float(), dim=1)
    c = logits.shape[1]
    onehot = labels[:, None] == torch.arange(
        c, device=labels.device, dtype=labels.dtype)[None, :, None, None]
    picked = torch.where(onehot, logp, 0.0).sum(dim=1)
    return -torch.where(valid, picked, 0.0).sum()


def seg_loss(logits: torch.Tensor, label: torch.Tensor,
             ignore_index: int = 255) -> torch.Tensor:
    """fg/bg-split cross-entropy, each normalised by its own pixel count
    (+1e-6), averaged. logits [B, C, H, W], label [B, H, W]; the counts
    are the process group's (module docstring)."""
    not_ignored = label != ignore_index
    bg = not_ignored & (label == 0)
    fg = not_ignored & (label != 0)
    bg_loss = _ce_sum(logits, label, bg) / (group_sum(bg.sum()) + 1e-6)
    fg_loss = _ce_sum(logits, label, fg) / (group_sum(fg.sum()) + 1e-6)
    return (bg_loss + fg_loss) * 0.5


def aff_loss(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Positive/negative-balanced affinity loss. inputs: sigmoid affinities
    [B, hw, hw]; targets: {0, 1, ignore} labels of the same shape; the
    counts are the process group's."""
    pos = (targets == 1).float()
    neg = (targets == 0).float()
    pos_loss = (pos * (1.0 - inputs)).sum() / (group_sum(pos.sum()) + 1.0)
    neg_loss = (neg * inputs).sum() / (group_sum(neg.sum()) + 1.0)
    return 0.5 * pos_loss + 0.5 * neg_loss
