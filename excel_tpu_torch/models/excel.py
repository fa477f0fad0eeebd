"""ExCEL composition (counterpart of excel_tpu/models/excel.py; the LVC
head, the trained forward and the text bank belong to later slices)."""
from __future__ import annotations

import torch

from ..ops.surgery import clip_feature_surgery


def compute_lams(image_out: dict, text_attr: torch.Tensor,
                 num_fg: int) -> torch.Tensor:
    """Feature surgery -> fg LAMs [B, hw, num_fg] (drop the CLS row and the
    background-class columns)."""
    maps = clip_feature_surgery(image_out["projected"], text_attr)
    return maps[:, 1:, :num_fg]
