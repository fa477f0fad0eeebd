"""Feature surgery (counterpart of excel_tpu/ops/surgery.py).

The reference's [B, N, T, C] elementwise product factors into two products:

    sim[b,n,t] = w[b,t] * (img @ text^T)[b,n,t] - (img @ m[b]^T)[b,n]
    m[b,c]     = mean_t  w[b,t] * text[t,c]

because the redundant features are a mean over the class axis of a
rank-1-in-C product.
"""
from __future__ import annotations

import torch


def clip_feature_surgery(image_features: torch.Tensor,
                         text_features: torch.Tensor) -> torch.Tensor:
    """LAM scores for every token (incl. CLS) against every class.

    image_features: [B, N, C] (token-dim normalised, CLS at index 0)
    text_features:  [T, C]
    Returns [B, N, T], min-max normalised over the token dim."""
    img = image_features.float()
    txt = text_features.float()
    # CLS-probability reweighting
    prob = torch.softmax(torch.matmul(img[:, 0, :], txt.t()) * 2.0, dim=-1)
    w = prob / prob.mean(dim=-1, keepdim=True)
    sim = torch.matmul(img, txt.t()) * w[:, None, :]
    m = torch.matmul(w, txt) / txt.shape[0]
    sim = sim - torch.matmul(img, m[:, :, None])
    lo = sim.amin(dim=1, keepdim=True)
    hi = sim.amax(dim=1, keepdim=True)
    return (sim - lo) / (hi - lo)
