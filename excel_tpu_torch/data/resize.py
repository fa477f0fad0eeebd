"""Host-side bilinear resize with torch `align_corners=False` semantics
(the port's copy of excel_tpu/data/resize.py).

The reference preprocesses eval images with `F.interpolate(..., mode=
'bilinear', align_corners=False)` (validatation_engine.py:20, infer_seg_voc
.py:68). PIL's BILINEAR antialiases on downscale, so it does NOT match;
this is the exact half-pixel-center gather+lerp (no antialias), vectorized
numpy, used by the host eval pipeline before batching.
"""
from __future__ import annotations

import numpy as np


def _axis_weights(in_size: int, out_size: int):
    # torch align_corners=False: src = (dst + 0.5) * (in/out) - 0.5, clamped
    src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w = (src - lo).astype(np.float32)
    return lo, hi, w


def resize_bilinear(image: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """image [H, W, C] or [H, W] float/uint8 -> float32 [out_h, out_w, ...]."""
    h, w = image.shape[:2]
    oh, ow = out_hw
    x = image.astype(np.float32)
    ylo, yhi, wy = _axis_weights(h, oh)
    xlo, xhi, wx = _axis_weights(w, ow)
    if x.ndim == 2:
        x = x[:, :, None]
        squeeze = True
    else:
        squeeze = False
    top = x[ylo][:, xlo] * (1 - wx)[None, :, None] + \
        x[ylo][:, xhi] * wx[None, :, None]
    bot = x[yhi][:, xlo] * (1 - wx)[None, :, None] + \
        x[yhi][:, xhi] * wx[None, :, None]
    out = top * (1 - wy)[:, None, None] + bot * wy[:, None, None]
    return out[:, :, 0] if squeeze else out
