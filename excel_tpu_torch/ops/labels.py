"""Pseudo-label utilities (counterpart of excel_tpu/ops/labels.py).

The per-image resizes reproduce `jax.image.scale_and_translate` with the
linear kernel (no antialiasing, as the JAX package's canvas upscales call
it; antialiased on request, as `jax.image.resize` is): each output
sample takes the triangle-kernel weights of its input neighbours,
renormalised where the kernel is cut by the input's edge, and samples whose
position falls outside the input ([-0.5, in - 0.5]) get weight 0. So a map
upscaled onto a canvas is 0 beyond its image's valid extent, not an edge
continuation.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .upsample_kernels import UpsampleLinear

_EPS32 = float(np.finfo(np.float32).eps)


def lam_to_label(cam: torch.Tensor, cls_label: torch.Tensor,
                 bkg_thre: float = 0.5, high_thre: float = 0.7,
                 low_thre: float = 0.25, ignore_mid: bool = False,
                 ignore_index: int = 255,
                 box_mask: torch.Tensor | None = None):
    """cam [B, C_fg, H, W], cls_label [B, C_fg] {0, 1} (the reference's
    camutils.py:123-143, batched).

    Returns (valid_cam, pseudo_label [B, H, W] int32): 0 is the background,
    1..C_fg the classes; ignore_index in the mid band (ignore_mid) and
    outside box_mask [B, H, W] bool."""
    valid_cam = cls_label[:, :, None, None] * cam
    cam_value = valid_cam.amax(dim=1)
    label = valid_cam.argmax(dim=1).to(torch.int32) + 1
    ignore = torch.tensor(ignore_index, dtype=torch.int32,
                          device=label.device)
    zero = torch.zeros_like(label)
    if ignore_mid:
        label = torch.where(cam_value <= high_thre, ignore, label)
        label = torch.where(cam_value <= low_thre, zero, label)
    else:
        label = torch.where(cam_value <= bkg_thre, zero, label)
    if box_mask is not None:
        label = torch.where(box_mask, label, ignore)
    return valid_cam, label


def boxes_to_masks(img_box: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, 4] (y0, y1, x0, x1) valid-crop boxes -> [B, h, w] bool masks."""
    dev = img_box.device
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    b = img_box[:, :, None, None]
    return ((ys >= b[:, 0]) & (ys < b[:, 1]) &
            (xs >= b[:, 2]) & (xs < b[:, 3]))


def linear_weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
                      translation: torch.Tensor,
                      antialias: bool = False) -> torch.Tensor:
    """[..., in_size, out_size] float32 weights of scale_and_translate's
    linear kernel for float32 `scale`/`translation` of any batch shape:
    output o samples input position
    (o + 0.5) / scale - translation / scale - 0.5. With `antialias` (the
    default of `jax.image.resize`) a downsample widens the triangle kernel
    by 1 / scale, so that each output averages the inputs it covers; an
    upsample is the same either way."""
    inv = 1.0 / scale.float()[..., None]
    translation = translation.float()[..., None]
    dev = inv.device
    sample = ((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5)
              * inv - translation * inv - 0.5)                    # [..., out]
    pos = torch.arange(in_size, dtype=torch.float32, device=dev)[:, None]
    dist = torch.abs(sample[..., None, :] - pos)
    if antialias:
        dist = dist / torch.clamp(inv, min=1.0)[..., None, :]
    weights = torch.clamp(1 - dist, min=0)
    total = weights.sum(dim=-2, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * _EPS32,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[..., None, :], weights,
                       torch.zeros_like(weights))


def scale_and_translate(x: torch.Tensor, out_hw: tuple[int, int],
                        scale: torch.Tensor, translation: torch.Tensor,
                        antialias: bool = False) -> torch.Tensor:
    """Per-image linear resize of x [B, C, h, w] to [B, C, *out_hw].
    scale, translation: [B, 2] float32 (y, x)."""
    _, _, h, w = x.shape
    wy = linear_weight_mat(h, out_hw[0], scale[:, 0], translation[:, 0],
                           antialias)
    wx = linear_weight_mat(w, out_hw[1], scale[:, 1], translation[:, 1],
                           antialias)
    t = torch.einsum("bchw,bwx->bchx", x.float(), wx)
    return torch.einsum("bchx,bhy->bcyx", t, wy)


def _minmax_per_map(cams: torch.Tensor) -> torch.Tensor:
    """scale_cam_image norm: x - min over the map, / (1e-7 + max)."""
    lo = cams.amin(dim=(-2, -1), keepdim=True)
    x = cams - lo
    return x / (1e-7 + x.amax(dim=(-2, -1), keepdim=True))


def upscale_to_canvas(x: torch.Tensor, valid_hw: torch.Tensor,
                      canvas_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinearly resize each image's [C, h, w] maps to its own valid extent
    on a fixed [C, H, W] canvas (half-pixel sampling); 0 beyond the extent.
    x: [B, C, h, w], valid_hw: [B, 2] int target extents."""
    _, _, h, w = x.shape
    hw = valid_hw.float()
    scale = torch.stack([hw[:, 0] / h, hw[:, 1] / w], dim=1)
    return scale_and_translate(x, canvas_hw, scale, torch.zeros_like(scale))


def upscale_to_canvas_align(x: torch.Tensor, valid_hw: torch.Tensor,
                            canvas_hw: tuple[int, int]) -> torch.Tensor:
    """`upscale_to_canvas` with align_corners=True sampling (out position o
    reads input o * (in-1)/(out-1)), the convention of the reference PAR's
    guidance-image resize."""
    _, _, h, w = x.shape
    hw = valid_hw.float()
    scale = torch.stack([(hw[:, 0] - 1.0) / (h - 1.0),
                         (hw[:, 1] - 1.0) / (w - 1.0)], dim=1)
    return scale_and_translate(x, canvas_hw, scale, 0.5 * (1.0 - scale))


def cams_with_background_canvas(refined: torch.Tensor,
                                cls_label: torch.Tensor,
                                valid_hw: torch.Tensor,
                                canvas_hw: tuple[int, int]) -> torch.Tensor:
    """refined [B, C, h, w] SVC outputs -> [B, 1+C, *canvas] scores: per map
    min-max normalised at grid resolution, upscaled to the image's extent,
    absent classes zeroed, background = 1 - max over classes."""
    x = upscale_to_canvas(_minmax_per_map(refined), valid_hw, canvas_hw)
    x = x * cls_label[:, :, None, None]
    bg = 1.0 - x.amax(dim=1, keepdim=True)
    return torch.cat([bg, x], dim=1)


def upsample_linear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """[B, C, h, w] -> [B, C, *out_hw] by an integer-factor linear upsample
    with half-pixel sampling (differentiable). The JAX package's
    `jax.image.resize(..., "linear")` equals `F.interpolate(bilinear,
    align_corners=False)` there: both weight the same two neighbours and
    hold the edge value beyond the outermost sample centres. Other factors
    raise: the two resizes part ways when downsampling (jax antialiases).
    The backward is a gather (ops/upsample_kernels.py), a CUDA kernel on
    the card."""
    h, w = x.shape[-2:]
    if out_hw[0] % h or out_hw[1] % w or out_hw[0] < h or out_hw[1] < w:
        raise ValueError(f"upsample_linear: {h}x{w} -> {out_hw} is not an "
                         "integer upsample")
    return UpsampleLinear.apply(x.float(), tuple(out_hw))


def cams_with_background(refined: torch.Tensor, cls_label: torch.Tensor,
                         out_hw: tuple[int, int]) -> torch.Tensor:
    """refined [B, C, h, w] SVC outputs -> [B, 1+C, *out_hw] scores at crop
    resolution: per map min-max normalised at grid resolution, upsampled,
    absent classes zeroed, background = 1 - max over classes."""
    x = upsample_linear(_minmax_per_map(refined), out_hw)
    x = x * cls_label[:, :, None, None]
    bg = 1.0 - x.amax(dim=1, keepdim=True)
    return torch.cat([bg, x], dim=1)


@functools.lru_cache(maxsize=8)
def radius_mask(h: int, w: int, radius: int) -> np.ndarray:
    """[hw, hw] float32 {0, 1}: grid-cell pairs within a Chebyshev box of
    `radius` (|dy| <= r and |dx| <= r); host numpy, built once per shape
    (callers must not write to it)."""
    ys, xs = np.mgrid[0:h, 0:w]
    ys, xs = ys.ravel(), xs.ravel()
    ok = ((np.abs(ys[:, None] - ys[None, :]) <= radius)
          & (np.abs(xs[:, None] - xs[None, :]) <= radius))
    return ok.astype(np.float32)


def affinity_label(cam_label: torch.Tensor, mask: torch.Tensor | None = None,
                   ignore_index: int = 255,
                   downscale: int = 16) -> torch.Tensor:
    """Pairwise label-equality affinity targets: cam_label [B, H, W] int
    nearest-downsampled by `downscale` (rows and columns 0, d, 2d, ...),
    aff[i, j] = (l_i == l_j), ignore_index where the radius mask is 0 or
    either cell is ignore_index. Returns [B, hw, hw] int32."""
    b, h, w = cam_label.shape
    gh, gw = h // downscale, w // downscale
    small = cam_label[:, ::downscale, ::downscale][:, :gh, :gw]
    flat = small.reshape(b, -1)
    aff = (flat[:, None, :] == flat[:, :, None]).to(torch.int32)
    ign = torch.tensor(ignore_index, dtype=torch.int32, device=aff.device)
    if mask is not None:
        aff = torch.where(mask[None] == 0, ign, aff)
    bad = flat == ignore_index
    aff = torch.where(bad[:, None, :], ign, aff)
    return torch.where(bad[:, :, None], ign, aff)


def class_slot_index(cls_label: torch.Tensor, slots: int):
    """Compact per-image present classes into `slots` fixed channel slots:
    bg + the first `slots` present classes in ascending class order.

    Returns (idx [B, slots] int64 fg-class indices — present classes first,
    absent-class padding after — and mask [B, slots], 1 for present).
    Exact iff every image has <= `slots` present classes."""
    c = cls_label.shape[1]
    present = (cls_label > 0).long()
    key = (1 - present) * c + torch.arange(c, device=cls_label.device)[None]
    idx = torch.argsort(key, dim=1, stable=True)[:, :slots]
    mask = torch.gather(cls_label, 1, idx)
    return idx, (mask > 0).to(cls_label.dtype)


def slot_label_to_class(slot_label: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """[B, H, W] argmax over (bg + slots) -> dataset label ids (bg=0, fg
    class i -> i+1)."""
    out = torch.zeros_like(slot_label)
    for s in range(idx.shape[1]):
        cls_id = (idx[:, s] + 1).to(slot_label.dtype)[:, None, None]
        out = torch.where(slot_label == s + 1, cls_id, out)
    return out


def argmax_label(cams: torch.Tensor, cls_label: torch.Tensor,
                 box_mask: torch.Tensor | None = None,
                 ignore_index: int = 255) -> torch.Tensor:
    """[B, 1+C_fg, H, W] scores -> [B, H, W] int32 labels, absent classes
    excluded (set to -inf before the argmax; ties take the first index);
    ignore_index outside box_mask [B, H, W] bool."""
    full = torch.cat([torch.ones_like(cls_label[:, :1]), cls_label], dim=1)
    scores = torch.where(full[:, :, None, None] > 0, cams,
                         torch.full_like(cams, -torch.inf))
    label = scores.argmax(dim=1).to(torch.int32)
    if box_mask is not None:
        label = torch.where(box_mask, label,
                            torch.full_like(label, ignore_index))
    return label
