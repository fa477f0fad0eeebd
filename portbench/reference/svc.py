"""SVC, the attention-affinity refinement of the LAMs.

Restates excel_tpu_torch/ops/affinity.py (`compute_trans_mat`,
`scoremap_box_mask`, `aggregate_attn`, `refine_lams`) for one image in
float32. The box mask keeps the reference's quirks: the score quantised to
uint8 by truncation, the threshold int(t * max), one box per 8-connected
component, its exclusive upper edge clipped to size - 1. Components are
found here by a breadth-first search on the host, a different algorithm
from the program's label propagation.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch


def trans_mat(attn):
    t = attn.float()
    for _ in range(3):
        t = t / t.sum(dim=0, keepdim=True)
        t = t / t.sum(dim=1, keepdim=True)
    t = (t + t.t()) / 2.0
    return t @ t


def box_mask(score, threshold):
    """score [h, w] -> float32 {0, 1} union of the components' boxes."""
    h, w = score.shape
    q = np.clip(score.detach().cpu().numpy().astype(np.float32) * 255.0,
                0, 255).astype(np.uint8).astype(np.int32)
    thr = int(np.float32(threshold) * np.float32(q.max()))
    binary = q > thr
    seen = np.zeros_like(binary)
    mask = np.zeros((h, w), np.float32)
    for sy, sx in zip(*np.nonzero(binary)):
        if seen[sy, sx]:
            continue
        seen[sy, sx] = True
        todo = deque([(sy, sx)])
        y0, y1, x0, x1 = sy, sy, sx, sx
        while todo:
            y, x = todo.popleft()
            y0, y1, x0, x1 = min(y0, y), max(y1, y), min(x0, x), max(x1, x)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    ny, nx = y + dy, x + dx
                    if (0 <= ny < h and 0 <= nx < w and binary[ny, nx]
                            and not seen[ny, nx]):
                        seen[ny, nx] = True
                        todo.append((ny, nx))
        mask[y0:min(y1 + 1, h - 1), x0:min(x1 + 1, w - 1)] = 1.0
    return torch.from_numpy(mask).to(score.device)


def aggregate_attn(stack, seg_attn=None):
    """stack [L, hw, hw] of the last L blocks' patch-patch weights; with
    the decoder's affinity seg_attn [hw, hw], keep the blocks whose summed
    deviation from it is at most the mean and multiply by it."""
    stack = stack.float()
    if seg_attn is None:
        return stack.mean(0)
    diff = (seg_attn[None] - stack).reshape(stack.shape[0], -1).sum(1)
    keep = (diff <= diff.mean()).float()[:, None, None]
    return (keep * stack).sum(0) / (keep.sum(0) + 1e-5) * seg_attn


def refine(lams, attn, threshold, grid):
    """lams [C, hw] (the image's present classes), attn [hw, hw] ->
    refined [C, hw]."""
    trans = trans_mat(attn)
    masks = torch.stack([box_mask(m.reshape(grid, grid), threshold)
                         .reshape(-1) for m in lams])
    return (trans @ (masks * lams).t()).t()
