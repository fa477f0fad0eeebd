"""Feature surgery and similarity maps (counterpart of
excel_tpu/ops/surgery.py).

The reference's [B, N, T, C] elementwise product factors into two products:

    sim[b,n,t] = w[b,t] * (img @ text^T)[b,n,t] - (img @ m[b]^T)[b,n]
    m[b,c]     = mean_t  w[b,t] * text[t,c]

because the redundant features are a mean over the class axis of a
rank-1-in-C product.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.resize import resize_bilinear
from .labels import scale_and_translate


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


def get_similarity_map(sm: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """[B, N_patches, T] scores -> [B, H, W, T] maps (the reference's
    clip/clip.py:272-285): min-max normalised over the tokens, laid on the
    square patch grid and resized linearly as `jax.image.resize` does it
    (half-pixel sampling; antialiased when shrinking). N_patches must be a
    square count (no CLS)."""
    lo = sm.amin(dim=1, keepdim=True)
    hi = sm.amax(dim=1, keepdim=True)
    sm = (sm - lo) / (hi - lo)
    b, n, t = sm.shape
    side = int(round(n ** 0.5))
    grid = sm.reshape(b, side, side, t).permute(0, 3, 1, 2)
    scale = torch.tensor([[shape[0] / side, shape[1] / side]],
                         dtype=torch.float32, device=sm.device).expand(b, 2)
    out = scale_and_translate(grid, tuple(shape), scale,
                              torch.zeros_like(scale), antialias=True)
    return out.permute(0, 2, 3, 1)


def similarity_map_to_points(sm, shape: tuple[int, int], t: float = 0.8,
                             down_sample: int = 2):
    """One class's similarity map -> positive and negative point prompts
    (the reference's clip/clip.py:314-346, the SAM-style point extraction),
    on the host: the number of points depends on the data.

    sm: [N_patches] scores (no CLS). Returns (points [[x, y], ...], labels
    uint8: 1 for each of the `num` highest cells, then 0 for each of the
    `num` lowest)."""
    sm = np.asarray(sm.cpu() if isinstance(sm, torch.Tensor) else sm,
                    np.float32)
    side = int(round(sm.shape[0] ** 0.5))
    down = side // down_sample
    small = resize_bilinear(sm.reshape(side, side), (down, down)).reshape(-1)
    small = (small - small.min()) / (small.max() - small.min())
    rank = np.argsort(small, kind="stable")
    scale_h = shape[0] / down
    scale_w = shape[1] / down

    num = int(min((small >= t).sum(), small.shape[0] // 2))
    labels = np.ones(num * 2, np.uint8)
    labels[num:] = 0

    def to_point(idx):
        x = min((idx % down + 0.5) * scale_w, shape[1] - 1)
        y = min((idx // down + 0.5) * scale_h, shape[0] - 1)
        return [int(x), int(y)]

    points = ([to_point(i) for i in rank[-num:]]
              + [to_point(i) for i in rank[:num]])
    return points, labels
