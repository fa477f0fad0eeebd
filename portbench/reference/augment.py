"""The training crops, worked out again from the raw images.

A frozen copy of excel_tpu_torch/data/transforms.py's resizes (Pillow's
BILINEAR and NEAREST, bit for bit, in numpy), random scaling, flip and
crop, and of data/loader.py's index stream and per-sample generators
(`_index_stream`, `train_batches`' (seed, step, slot) seeding) and
data/datasets.ClsCropDataset's order of draws: the reference builds each
training batch itself from the pool's arrays.
"""
from __future__ import annotations

import math

import numpy as np

_PRECISION_BITS = 22


def _bilinear_coeffs(in_size: int, out_size: int):
    """(first tap [out], fixed-point weights [out, ksize] int32) of Pillow's
    `precompute_coeffs` + `normalize_coeffs_8bpc` for its bilinear filter
    (support 1). Weights beyond a pixel's last tap are 0."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates; a negative start is clipped to 0 either way
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    taps = np.arange(ksize)
    x = (taps[None, :] + xmin[:, None]).astype(np.float64)
    w = np.abs((x - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where((w < 1.0) & (taps[None, :] < xmax[:, None]), 1.0 - w, 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):             # Pillow's sequential float64 sum
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    fixed = np.trunc(0.5 + w * (1 << _PRECISION_BITS)).astype(np.int32)
    return xmin, fixed


def _bilinear_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass of Pillow's bilinear resample along `axis` (0 rows,
    1 columns) of a uint8 [h, w(, c)] image."""
    in_size = img.shape[axis]
    xmin, fixed = _bilinear_coeffs(in_size, out_size)
    # taps past the input carry weight 0; clip their index to stay in range
    idx = np.minimum(xmin[:, None] + np.arange(fixed.shape[1])[None, :],
                     in_size - 1)
    shape = [1] * img.ndim
    shape[axis] = out_size
    # int32 cannot overflow: 255 x (2^22 + ksize / 2) + 2^21 < 2^31
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)
    for k in range(fixed.shape[1]):
        acc += (np.take(img, idx[:, k], axis=axis).astype(np.int32)
                * fixed[:, k].reshape(shape))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _nearest_index(in_size: int, out_size: int):
    """(source index, in range) of Pillow's NEAREST scale along one axis."""
    a = float(in_size) / out_size
    pos = np.cumsum(np.concatenate([[a * 0.5], np.full(out_size - 1, a)]))
    src = np.where(pos < 0.0, -1, np.trunc(pos)).astype(np.int64)
    ok = (src >= 0) & (src < in_size)
    return np.clip(src, 0, in_size - 1), ok


def resize_pil_bilinear(image: np.ndarray, size: tuple[int, int]):
    """Pillow's `Image.fromarray(image).resize(size, BILINEAR)` of a uint8
    [h, w] or [h, w, c] image; size = (width, height)."""
    ow, oh = size
    if ow < 1 or oh < 1:
        raise ValueError("height and width must be > 0")
    img = np.asarray(image, np.uint8)
    if img.shape[1] != ow:
        img = _bilinear_axis(img, ow, 1)
    if img.shape[0] != oh:
        img = _bilinear_axis(img, oh, 0)
    return np.array(img)


def resize_pil_nearest(image: np.ndarray, size: tuple[int, int]):
    """Pillow's `Image.fromarray(image).resize(size, NEAREST)` of an
    [h, w] or [h, w, c] array; size = (width, height)."""
    ow, oh = size
    if ow < 1 or oh < 1:
        raise ValueError("height and width must be > 0")
    h, w = image.shape[:2]
    if (w, h) == (ow, oh):
        return np.array(image)
    ys, yok = _nearest_index(h, oh)
    xs, xok = _nearest_index(w, ow)
    out = image[ys][:, xs]
    keep = yok[:, None] & xok[None, :]
    if not keep.all():
        out = np.where(keep.reshape(keep.shape + (1,) * (out.ndim - 2)),
                       out, 0)
    return out


def rescale(image: np.ndarray, scale: float,
            label: np.ndarray | None = None):
    """Bilinear image / nearest label resize by a scale factor (new size
    (int(s*w), int(s*h))), as Pillow computes them."""
    h, w = image.shape[:2]
    size = (int(scale * w), int(scale * h))
    img = resize_pil_bilinear(image.astype(np.uint8), size)
    if label is None:
        return img
    return img, resize_pil_nearest(label, size)


def random_scaling(image: np.ndarray, rng: np.random.Generator,
                   scale_range=(0.5, 2.0), label: np.ndarray | None = None):
    scale = rng.uniform(*scale_range)
    return rescale(image, scale, label)


def random_fliplr(image: np.ndarray, rng: np.random.Generator,
                  label: np.ndarray | None = None):
    if rng.random() > 0.5:
        image = np.fliplr(image)
        label = np.fliplr(label) if label is not None else None
    return image if label is None else (image, label)


def random_crop(image: np.ndarray, rng: np.random.Generator,
                crop_size: int, label: np.ndarray | None = None,
                mean_rgb=(0, 0, 0), ignore_index: int = 255,
                cat_max_ratio: float = 0.75):
    """Pad to the crop size, then a random window, drawn again (up to 10
    times) while one class covers cat_max_ratio or more of its labelled
    pixels. Returns (image, [label,] img_box) where img_box = [y0, y1, x0,
    x1] marks the valid (non-padding) region."""
    h, w = image.shape[:2]
    H, W = max(crop_size, h), max(crop_size, w)
    pad_img = np.empty((H, W, 3), dtype=image.dtype)
    pad_img[...] = np.asarray(mean_rgb, dtype=image.dtype)
    y_pad = rng.integers(0, H - h + 1)
    x_pad = rng.integers(0, W - w + 1)
    pad_img[y_pad:y_pad + h, x_pad:x_pad + w] = image

    pad_lab = None
    if label is not None:
        pad_lab = np.full((H, W), ignore_index, dtype=label.dtype)
        pad_lab[y_pad:y_pad + h, x_pad:x_pad + w] = label

    y0 = x0 = 0
    for _ in range(10):
        y0 = int(rng.integers(0, H - crop_size + 1))
        x0 = int(rng.integers(0, W - crop_size + 1))
        if pad_lab is None:
            break
        win = pad_lab[y0:y0 + crop_size, x0:x0 + crop_size]
        idx, cnt = np.unique(win, return_counts=True)
        cnt = cnt[idx != ignore_index]
        if cnt.size and cnt.max() / cnt.sum() < cat_max_ratio:
            break

    img = pad_img[y0:y0 + crop_size, x0:x0 + crop_size]
    img_box = np.asarray([max(y_pad - y0, 0),
                          min(y0 + crop_size, y_pad + h) - y0,
                          max(x_pad - x0, 0),
                          min(x0 + crop_size, x_pad + w) - x0],
                         dtype=np.int32)
    if label is None:
        return img, img_box
    return img, pad_lab[y0:y0 + crop_size, x0:x0 + crop_size], img_box


def index_stream(dataset_len: int, global_batch: int, seed: int):
    """One permutation an epoch, leftovers carried over (data/loader.py)."""
    rng = np.random.default_rng(seed)
    pool: list[int] = []
    while True:
        while len(pool) < global_batch:
            pool.extend(rng.permutation(dataset_len).tolist())
        idxs, pool[:] = pool[:global_batch], pool[global_batch:]
        yield idxs


def crop_sample(image, label, cls_label, rng, crop_size, rescale_range,
                ignore_index=255):
    """ClsCropDataset's sample: scale, flip, pad-crop; the image-level
    labels are the whole image's."""
    image, label = random_scaling(image, rng, rescale_range, label=label)
    image, label = random_fliplr(image, rng, label=label)
    image, label, img_box = random_crop(image, rng, crop_size, label=label,
                                        ignore_index=ignore_index)
    return np.ascontiguousarray(image), np.asarray(cls_label, np.float32)


def batches(pool, batch_size, seed, crop_size, rescale_range):
    """The training batches of one process: (images uint8 [B, S, S, 3],
    cls [B, num_fg]) in the loader's order."""
    for step, idxs in enumerate(index_stream(len(pool), batch_size, seed)):
        imgs, cls = [], []
        for slot, i in enumerate(idxs):
            rng = np.random.default_rng((seed, step, slot))
            s = pool[int(i)]
            im, c = crop_sample(s["image"], s["label"], s["cls_label"], rng,
                                crop_size, rescale_range)
            imgs.append(im)
            cls.append(c)
        yield np.stack(imgs), np.stack(cls)
