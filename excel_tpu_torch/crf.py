"""The host dense CRF: ctypes binding to the permutohedral lattice
(counterpart of excel_tpu/crf.py, over the port's own copy of
native/densecrf.cpp).

- `DenseCRF(iter_max, pos_w, pos_xy_std, bi_w, bi_xy_std, bi_rgb_std)`,
  called on (image uint8 [H, W, 3], probmap [C, H, W]), returns the refined
  Q [C, H, W] (the reference's utils/dcrf.py DenseCRF);
- `crf_inference` and `crf_inference_label`: the reference's two fixed
  parameter sets;
- `crf_batch`: many images on a thread pool (the C call releases the
  interpreter lock).

The library is built with g++ at first use into the port's `_build/`
(`build.build_host`); a missing g++ or a failed build raises.
"""
from __future__ import annotations

import ctypes
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import build

_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is None:
            build.build_host()
            lib = ctypes.CDLL(build.host_library_path())
            lib.excel_dcrf_inference.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),     # image
                ctypes.POINTER(ctypes.c_float),     # probs
                ctypes.POINTER(ctypes.c_float),     # out
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ]
            lib.excel_dcrf_inference.restype = None
            _lib = lib
        return _lib


class DenseCRF:
    """The reference's DenseCRF (utils/dcrf.py:42-68): Gaussian pairwise
    (x, y) + bilateral pairwise (x, y, r, g, b), Potts compatibility,
    `iter_max` mean-field iterations."""

    def __init__(self, iter_max: int = 10, pos_w: float = 3.0,
                 pos_xy_std: float = 1.0, bi_w: float = 4.0,
                 bi_xy_std: float = 67.0, bi_rgb_std: float = 3.0):
        self.iter_max = iter_max
        self.pos_w = pos_w
        self.pos_xy_std = pos_xy_std
        self.bi_w = bi_w
        self.bi_xy_std = bi_xy_std
        self.bi_rgb_std = bi_rgb_std

    def __call__(self, image: np.ndarray, probmap: np.ndarray) -> np.ndarray:
        lib = _load()
        c, h, w = probmap.shape
        if image.shape != (h, w, 3):
            raise ValueError(f"DenseCRF: image {image.shape} against "
                             f"probabilities {probmap.shape}")
        img = np.ascontiguousarray(image, np.uint8)
        probs = np.ascontiguousarray(probmap, np.float32)
        out = np.empty_like(probs)
        lib.excel_dcrf_inference(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            h, w, c, self.iter_max,
            self.pos_w, self.pos_xy_std,
            self.bi_w, self.bi_xy_std, self.bi_rgb_std)
        return out


def crf_inference(img: np.ndarray, probs: np.ndarray, t: int = 10,
                  labels: int = 21) -> np.ndarray:
    """The reference's crf_inference parameter set (utils/dcrf.py:7-24):
    Gaussian sxy=3 / compat=3, bilateral sxy=80 / srgb=13 / compat=10."""
    del labels  # from the shape
    crf = DenseCRF(iter_max=t, pos_w=3.0, pos_xy_std=3.0,
                   bi_w=10.0, bi_xy_std=80.0, bi_rgb_std=13.0)
    return crf(img, probs)


def crf_inference_label(img: np.ndarray, labels: np.ndarray, t: int = 10,
                        n_labels: int = 21, gt_prob: float = 0.7) -> np.ndarray:
    """The label-unary variant (utils/dcrf.py:26-40): gt_prob on each
    pixel's label, 1 - gt_prob spread over the other classes; Gaussian
    sxy=3 / compat=3, bilateral sxy=50 / srgb=5 / compat=10. Returns the
    argmax label map."""
    h, w = labels.shape
    probs = np.full((n_labels, h, w), (1.0 - gt_prob) / (n_labels - 1),
                    np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    probs[labels.astype(np.int64), ys, xs] = gt_prob
    crf = DenseCRF(iter_max=t, pos_w=3.0, pos_xy_std=3.0,
                   bi_w=10.0, bi_xy_std=50.0, bi_rgb_std=5.0)
    return crf(img, probs).argmax(0)


def crf_batch(items, crf: DenseCRF, num_threads: int = 2) -> list:
    """[(image, probmap), ...] -> [Q, ...], in order, on `num_threads`
    threads."""
    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        return list(pool.map(lambda a: crf(*a), items))
