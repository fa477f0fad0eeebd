"""Colormaps, label encoding, palette PNG export and CAM overlays (the
port's copy of excel_tpu/utils/visual.py, writing PNGs with the port's own
codec, data/png.py, since the machine with the card has no Pillow).
"""
from __future__ import annotations

import functools

import numpy as np

from ..data.png import write_png


@functools.lru_cache(maxsize=2)
def colormap(n: int = 256) -> np.ndarray:
    """VOC bit-trick colormap [n, 3] uint8."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def encode_cmap(label: np.ndarray) -> np.ndarray:
    """int label map -> RGB uint8."""
    return colormap()[label.astype(np.int32)]


def save_palette_png(label: np.ndarray, path: str,
                     num_classes: int = 21) -> None:
    """Indexed-palette PNG in the VOC evaluation server's format: the VOC
    colormap for the first `num_classes` entries, grey (i, i, i) for the
    rest of the 256."""
    palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    palette[:num_classes] = colormap()[:num_classes]
    write_png(path, label.astype(np.uint8), palette)


def cam_overlay(image_u8: np.ndarray, cam: np.ndarray,
                alpha: float = 0.5) -> np.ndarray:
    """Jet-style CAM overlay: cam in [0, 1] -> RGB heat blended onto the
    image, uint8 [h, w, 3]."""
    c = np.clip(cam, 0.0, 1.0)
    heat = np.stack([
        np.clip(1.5 - np.abs(4 * c - 3.0), 0, 1),
        np.clip(1.5 - np.abs(4 * c - 2.0), 0, 1),
        np.clip(1.5 - np.abs(4 * c - 1.0), 0, 1),
    ], axis=-1)
    out = (1 - alpha) * image_u8.astype(np.float32) / 255.0 + alpha * heat
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)
