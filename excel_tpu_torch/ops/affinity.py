"""SVC — attention-affinity LAM refinement (counterpart of
excel_tpu/ops/affinity.py).

Batched over images and class maps: the cv2 contour boxes of the reference
become 8-connected component labels by min-label propagation on the score
grid, then the union of the components' bounding boxes, with the reference's
quirks kept (uint8 truncation of the score, threshold int(t * max), the
exclusive box edge clipped to size - 1). The per-class masked products
collapse into one [hw, hw] @ [hw, C] product per image.
"""
from __future__ import annotations

import torch

from ..utils import profiling


def compute_trans_mat(attn: torch.Tensor) -> torch.Tensor:
    """Sinkhorn-style normalisation + symmetrise + one squaring.
    attn: [..., hw, hw]."""
    t = attn.float()
    t = t / t.sum(dim=-2, keepdim=True)
    t = t / t.sum(dim=-1, keepdim=True)
    for _ in range(2):
        t = t / t.sum(dim=-2, keepdim=True)
        t = t / t.sum(dim=-1, keepdim=True)
    t = (t + t.transpose(-1, -2)) / 2.0
    return torch.matmul(t, t)


# sweeps between two convergence tests of `_propagate_labels`: each test
# waits for the device, and a sweep past the fixed point changes nothing
SWEEPS_PER_TEST = 8


def _propagate_labels(mask: torch.Tensor) -> torch.Tensor:
    """8-connected component labels of [M, h, w] bool masks by min-label
    propagation to a fixed point. Returns [M, h, w] int64; background pixels
    get h*w.

    A sweep never raises a label, so labels equal after SWEEPS_PER_TEST
    sweeps were equal after each of them: the fixed point is tested once
    every SWEEPS_PER_TEST sweeps, and the result is exact (the JAX package
    tests it every sweep inside a device loop)."""
    m, h, w = mask.shape
    big = h * w
    with profiling.span("svc.propagate"):
        lab = torch.where(
            mask, torch.arange(big, device=mask.device).reshape(1, h, w),
            torch.full((1, h, w), big, device=mask.device))
        while True:
            before = lab
            for _ in range(SWEEPS_PER_TEST):
                p = torch.nn.functional.pad(lab, (1, 1, 1, 1), value=big)
                neigh = torch.stack([p[:, dy:dy + h, dx:dx + w]
                                     for dy in range(3) for dx in range(3)])
                lab = torch.where(mask, neigh.amin(dim=0), big)
            profiling.count("svc.syncs")      # the test waits for the device
            if torch.equal(lab, before):
                return lab


def scoremap_box_mask(score: torch.Tensor, threshold: float) -> torch.Tensor:
    """Union of per-component bounding boxes of thresholded score maps.

    score: [M, h, w] float (min-max normalised LAMs). Quantise to uint8 by
    truncation, binary threshold at int(threshold * max), one bbox per
    8-connected component with the exclusive upper edge clipped to size-1.
    Returns [M, h, w] float32 {0, 1} masks."""
    m, h, w = score.shape
    q = torch.clamp(score * 255.0, 0, 255).to(torch.uint8)
    qmax = q.reshape(m, -1).amax(dim=1).float()
    thr = (threshold * qmax).to(torch.int32)
    binary = q.to(torch.int32) > thr[:, None, None]

    lab = _propagate_labels(binary).reshape(m, -1)             # [M, n]
    n = h * w
    dev = score.device
    rows = (torch.arange(n, device=dev) // w).expand(m, n)
    cols = (torch.arange(n, device=dev) % w).expand(m, n)

    def seg(src, init, reduce):
        out = torch.full((m, n + 1), init, dtype=torch.long, device=dev)
        return out.scatter_reduce(1, lab, src, reduce=reduce)[:, :n]

    y0 = seg(rows, n, "amin")
    y1 = torch.clamp(seg(rows, -1, "amax") + 1, max=h - 1)
    x0 = seg(cols, n, "amin")
    x1 = torch.clamp(seg(cols, -1, "amax") + 1, max=w - 1)
    count = torch.zeros((m, n + 1), dtype=torch.long, device=dev).scatter_add(
        1, lab, torch.ones_like(lab))[:, :n]
    valid = count > 0

    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    row_in = (valid[:, :, None] & (ys >= y0[:, :, None])
              & (ys < y1[:, :, None])).float()                 # [M, n, h]
    col_in = ((xs >= x0[:, :, None]) & (xs < x1[:, :, None])).float()
    return (torch.matmul(row_in.transpose(1, 2), col_in) > 0).float()


def aggregate_attn(attn_weights: torch.Tensor, attn_layers: int,
                   seg_attn: torch.Tensor | None = None,
                   patch_start: int = 1) -> torch.Tensor:
    """Mean of the last `attn_layers` blocks' patch-patch attention; with a
    decoder attention, keep only blocks whose deviation from it is below the
    mean and multiply by it.

    attn_weights: [B, L, hw+1, hw+1] (the patch rows from patch_start: [B,
    L, hw, hw] with 0); seg_attn: optional [B, hw, hw].
    Returns [B, hw, hw]."""
    s = patch_start
    aw = attn_weights[:, -attn_layers:, s:, s:].float()
    if seg_attn is None:
        return aw.mean(dim=1)
    b = aw.shape[0]
    diff = (seg_attn[:, None] - aw).reshape(b, attn_layers, -1).sum(dim=2)
    keep = (diff <= diff.mean(dim=1, keepdim=True)).float()[:, :, None, None]
    merged = (keep * aw).sum(dim=1) / (keep.sum(dim=1) + 1e-5)
    return merged * seg_attn


def refine_lams(lams: torch.Tensor, attn: torch.Tensor, caa_threshold: float,
                grid_hw: tuple[int, int]) -> torch.Tensor:
    """SVC refinement of every class map of one image (the reference's
    affutils.py:200-221). lams [C, hw] raw LAM scores (min-max normalised,
    patch tokens only), attn [hw, hw] aggregated attention
    (`aggregate_attn`). Returns refined [C, hw] (absent classes give garbage
    rows; they are masked downstream). Leading batch dimensions ([B, C, hw]
    with [B, hw, hw]) are mapped over."""
    h, w = grid_hw
    trans = compute_trans_mat(attn)
    masks = scoremap_box_mask(lams.reshape(-1, h, w), caa_threshold)
    masked = masks.reshape(lams.shape) * lams
    return torch.matmul(trans, masked.transpose(-1, -2)).transpose(-1, -2)


def refine_lams_batch(lams: torch.Tensor, attn_weights: torch.Tensor,
                      caa_threshold: float, grid_hw: tuple[int, int],
                      attn_layers: int = 6,
                      seg_attn: torch.Tensor | None = None,
                      patch_start: int = 1) -> torch.Tensor:
    """Batched SVC. lams [B, C, hw] raw LAM scores; attn_weights either the
    per-block stack [L, B, N, N] or the pre-aggregated block mean [B, N, N]
    (the encoder's attn_mode="mean" output, only valid without seg_attn),
    whose patch rows and columns start at patch_start (1 after a CLS
    token, 0 without one: `ClipConfig.patch_start`).
    Returns refined [B, C, hw]: `refine_lams` of each image."""
    if attn_weights.dim() == 3 and seg_attn is not None:
        raise ValueError("pre-aggregated attention cannot drive the "
                         "seg_attn keep-mask (needs the per-block stack)")
    with profiling.span("svc"):
        s = patch_start
        if attn_weights.dim() == 3:
            agg = attn_weights[:, s:, s:].float()
        else:
            agg = aggregate_attn(attn_weights.transpose(0, 1), attn_layers,
                                 seg_attn, patch_start=s)
        return refine_lams(lams, agg, caa_threshold, grid_hw)
