"""Seeded synthetic scenes and the dataset trees the program reads.

`draw_scene` is the benchmark's copy of the program's
data/synthetic._draw_sample (coloured elliptical blobs on a textured
background, exact masks), redrawn to a traffic mix's shapes and class
counts: each scene gets its (h, w) and its number of classes from the mix,
and its blobs are redrawn until every class shows. A pool's multiset of
shapes and class counts is fixed by the mix (largest-remainder quotas,
evenly spaced short sides, paired the same way), so every seed gives the
same work in another order and with other content.

`write_tree` writes a pool in the VOC or COCO layout that the program's
data/datasets readers take: images as baseline JPEG at the mix's
"jpeg_quality" with 4:2:0 chroma, as VOC's and COCO's files are (Pillow
writes them; the program reads them with its own decoder), masks as
greyscale PNG, a split list and cls_labels.npz. Each pool entry's image
is then replaced by Pillow's decode of the file written, so the
reference starts from the pixels that the file holds.
"""
from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np

from .seeds import sub_seed


def quotas(weights: list, n: int, at_least_one: bool = True) -> list[int]:
    """Largest-remainder integer counts of n in proportion to weights,
    each at least 1 where n allows it."""
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    base = np.floor(w * n).astype(int)
    if at_least_one and n >= len(w):
        base = np.maximum(base, 1)
    while base.sum() > n:
        i = int(np.argmax(np.where(base > 1, base - w * n, -np.inf)))
        base[i] -= 1
    rem = w * n - base
    while base.sum() < n:
        i = int(np.argmax(rem))
        base[i] += 1
        rem[i] -= 1
    return base.tolist()


def pool_plan(mix: dict, n: int) -> list[tuple[int, int, int]]:
    """The pool's (h, w, classes) before shuffling: a fixed multiset."""
    values = [v for v, _ in mix["classes_per_image"]]
    counts = quotas([p for _, p in mix["classes_per_image"]], n)
    classes = [v for v, c in zip(values, counts) for _ in range(c)]
    lo, hi = mix["short_side"]
    n_land = int(round(mix["landscape_share"] * n))
    shapes = []
    for j in range(n):
        short = int(round(lo + (hi - lo) * ((j * 7919) % n + 0.5) / n))
        long = mix["long_side"]
        shapes.append((short, long) if j < n_land else (long, short))
    return [(h, w, k) for (h, w), k in zip(shapes, classes)]


def draw_scene(rng: np.random.Generator, h: int, w: int, k: int,
               num_fg: int):
    """(image uint8 [h, w, 3], label uint8 [h, w]) with k classes."""
    image = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
    palette = rng.integers(100, 256, (num_fg + 1, 3))
    classes = rng.choice(np.arange(1, num_fg + 1), size=k, replace=False)
    shrink = max(1.0, k ** 0.5)
    ys, xs = np.ogrid[:h, :w]
    for _ in range(20):
        label = np.zeros((h, w), np.uint8)
        img = image.copy()
        for cls in classes:
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            ry = rng.integers(max(4, int(h / 8 / shrink)),
                              max(5, int(h / 3 / shrink)))
            rx = rng.integers(max(4, int(w / 8 / shrink)),
                              max(5, int(w / 3 / shrink)))
            blob = ((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 <= 1
            img[blob] = palette[cls]
            label[blob] = cls
        if len(np.setdiff1d(classes, np.unique(label))) == 0:
            break
    return img, label


def make_pool(mix: dict, num_fg: int, seed: int) -> list[dict]:
    """The seeded pool: [{"name", "image", "label", "cls_label"}]."""
    n = mix["pool_images"]
    rng = np.random.default_rng(sub_seed(seed, "pool"))
    plan = pool_plan(mix, n)
    pool = []
    for i, j in enumerate(rng.permutation(n)):
        h, w, k = plan[j]
        image, label = draw_scene(rng, h, w, min(k, num_fg), num_fg)
        cls = np.zeros(num_fg, np.float32)
        present = np.unique(label)
        cls[present[present > 0].astype(int) - 1] = 1.0
        pool.append({"name": name_of(mix, i), "image": image,
                     "label": label, "cls_label": cls})
    return pool


COCO_PREFIX = {"train": "COCO_train2014_", "val": "COCO_val2014_"}


def name_of(mix: dict, i: int) -> str:
    if mix["layout"] == "coco":
        return COCO_PREFIX[_coco_sub(mix["split"])] + f"{i + 1:012d}"
    return f"pb_{i:06d}"


def _coco_sub(split: str) -> str:
    return "train" if "train" in split else "val"


def _png(pixels: np.ndarray) -> bytes:
    """8-bit greyscale PNG, filter 0, zlib level 1."""
    h, w = pixels.shape
    raw = np.zeros((h, 1 + w), np.uint8)
    raw[:, 1:] = pixels.reshape(h, -1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + chunk(b"IEND", b""))


def _jpeg(pixels: np.ndarray, quality: int) -> tuple[bytes, np.ndarray]:
    """Baseline JPEG bytes (4:2:0) of RGB pixels, and their decode."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="JPEG", quality=quality,
                                 subsampling="4:2:0")
    data = buf.getvalue()
    with Image.open(io.BytesIO(data)) as im:
        return data, np.array(im.convert("RGB"))


def write_tree(pool: list[dict], mix: dict, root: str) -> str:
    """Write the pool under root in the mix's layout; returns the split
    dir (split list and cls_labels.npz). Each entry's "image" becomes the
    decode of its JPEG file."""
    split = mix["split"]
    if mix["layout"] == "coco":
        sub = _coco_sub(split)
        img_dir = os.path.join(root, "JPEGImages", sub)
        lab_dir = os.path.join(root, "SegmentationClass", sub)
        cut = len(COCO_PREFIX[sub])
    else:
        img_dir = os.path.join(root, "JPEGImages")
        lab_dir = os.path.join(root, "SegmentationClassAug")
        cut = 0
    split_dir = os.path.join(root, "splits")
    for d in (img_dir, lab_dir, split_dir):
        os.makedirs(d, exist_ok=True)
    for s in pool:
        data, s["image"] = _jpeg(s["image"], mix["jpeg_quality"])
        with open(os.path.join(img_dir, s["name"] + ".jpg"), "wb") as f:
            f.write(data)
        with open(os.path.join(lab_dir, s["name"][cut:] + ".png"), "wb") as f:
            f.write(_png(s["label"]))
    with open(os.path.join(split_dir, split + ".txt"), "w") as f:
        f.write("\n".join(s["name"] for s in pool) + "\n")
    np.savez(os.path.join(split_dir, "cls_labels.npz"),
             names=np.asarray([s["name"] for s in pool]),
             labels=np.stack([s["cls_label"] for s in pool]).astype(np.uint8))
    return split_dir
