"""Synthetic mini-dataset generator in the VOC directory layout (the port's
copy of excel_tpu/data/synthetic.py).

The same arrays from the same numpy generator as the JAX package's
`make_voc_tree`: coloured elliptical blobs on a textured background, with
exact segmentation masks. One difference of form: each image is stored
losslessly as PNG bytes under the layout's `JPEGImages/<name>.jpg` name
(the machine with the card has no JPEG decoder, and a lossless image makes
every reader see the same pixels). Readers that detect the format from the
file's signature (Pillow, `datasets.read_image`) read it as it is.

`make_coco_tree` writes the same kind of samples in the COCO layout, with
palette masks (as COCO's SegmentationClass PNGs are) and an ignore band,
for the tools and CLIs that read COCO trees; the JAX package has no
counterpart.

`crf_scene` makes the structured scenes on which the host lattice CRF and
the on-device mean-field CRF are held against each other.
"""
from __future__ import annotations

import os

import numpy as np

from .png import write_png


def _draw_sample(rng: np.random.Generator, size_range=(200, 400),
                 num_fg: int = 20, max_objects: int = 3):
    h = int(rng.integers(*size_range))
    w = int(rng.integers(*size_range))
    image = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
    label = np.zeros((h, w), np.uint8)
    palette = rng.integers(100, 256, (num_fg + 1, 3))
    for _ in range(int(rng.integers(1, max_objects + 1))):
        cls = int(rng.integers(1, num_fg + 1))
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        ry, rx = rng.integers(h // 8, h // 3), rng.integers(w // 8, w // 3)
        ys, xs = np.ogrid[:h, :w]
        blob = ((ys - cy) / max(ry, 1)) ** 2 + ((xs - cx) / max(rx, 1)) ** 2 <= 1
        image[blob] = palette[cls]
        label[blob] = cls
    return image, label


def crf_scene(kind: str, seed: int = 0, hw=(192, 256), num_classes: int = 21):
    """Structured scene for CRF validation -> (image u8 [H,W,3], gt [H,W],
    probs [C,H,W]).

    kinds: 'blobs' (smooth colored regions — the CRF's best case), 'thin'
    (3-px structures the bilateral kernel must preserve), 'texture'
    (high-frequency intra-region color noise degrading the bilateral term).
    The unary is the GT at ~0.6 confidence with blocky label flips (spatially
    correlated noise, the realistic failure mode of coarse seg logits).
    """
    rng = np.random.default_rng(seed)
    h, w = hw
    gt = np.zeros((h, w), np.int64)
    palette = np.asarray([(60, 60, 60), (200, 50, 40), (40, 170, 60),
                          (40, 80, 210), (210, 200, 50)], np.float32)
    if kind == "blobs":
        ys, xs = np.ogrid[:h, :w]
        for cls, (cy, cx, ry, rx) in enumerate(
                [(60, 70, 45, 55), (130, 180, 50, 60), (50, 200, 30, 40),
                 (150, 60, 35, 45)], start=1):
            blob = ((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 <= 1
            gt[blob] = cls
        noise_std = 6.0
    elif kind == "thin":
        for cls, x0 in enumerate(range(20, w - 20, 34), start=1):
            c = 1 + (cls - 1) % 4
            gt[:, x0:x0 + 3] = c
        gt[h // 2:h // 2 + 3, :] = 4                    # one horizontal bar
        noise_std = 6.0
    elif kind == "texture":
        gt[:, w // 3: 2 * w // 3] = 1
        gt[:, 2 * w // 3:] = 2
        gt[: h // 3, :] = np.where(gt[: h // 3, :] == 0, 3, gt[: h // 3, :])
        noise_std = 35.0                                # intra-region texture
    else:
        raise ValueError(kind)
    image = palette[np.minimum(gt, len(palette) - 1)]
    image = image + rng.normal(0, noise_std, image.shape)
    image = np.clip(image, 0, 255).astype(np.uint8)

    # blocky spatially-correlated label flips at 16-px granularity
    noisy = gt.copy()
    for _ in range(18):
        by = int(rng.integers(0, h - 16))
        bx = int(rng.integers(0, w - 16))
        noisy[by:by + 16, bx:bx + 16] = int(rng.integers(0, 5))
    conf = 0.55 + 0.15 * rng.random((h, w)).astype(np.float32)
    probs = np.full((num_classes, h, w), 0.0, np.float32)
    rest = (1.0 - conf) / (num_classes - 1)
    probs[:] = rest[None]
    ys, xs = np.mgrid[0:h, 0:w]
    probs[noisy, ys, xs] = conf
    probs /= probs.sum(0, keepdims=True)
    return image, gt, probs


def make_voc_tree(root: str, num_images: int = 8, seed: int = 0,
                  num_fg: int = 20, size_range=(200, 400)) -> str:
    """Write JPEGImages/ (PNG bytes under .jpg names) +
    SegmentationClassAug/ (greyscale PNGs) + split lists + cls labels under
    `root`; returns the split dir."""
    img_dir = os.path.join(root, "JPEGImages")
    lab_dir = os.path.join(root, "SegmentationClassAug")
    split_dir = os.path.join(root, "splits")
    for d in (img_dir, lab_dir, split_dir):
        os.makedirs(d, exist_ok=True)

    rng = np.random.default_rng(seed)
    names, onehots = [], []
    for i in range(num_images):
        name = f"synth_{i:06d}"
        image, label = _draw_sample(rng, size_range, num_fg)
        write_png(os.path.join(img_dir, name + ".jpg"), image)
        write_png(os.path.join(lab_dir, name + ".png"), label)
        onehot = np.zeros(num_fg, np.uint8)
        present = np.unique(label)
        onehot[present[present > 0] - 1] = 1
        names.append(name)
        onehots.append(onehot)

    for split in ("train_aug", "train", "val", "test"):
        with open(os.path.join(split_dir, split + ".txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    np.savez(os.path.join(split_dir, "cls_labels.npz"),
             names=np.asarray(names), labels=np.stack(onehots))
    return split_dir


# COCO's file-name prefixes; `CocoDataset.label_path` drops them
COCO_PREFIX = {"train": "COCO_train2014_", "val": "COCO_val2014_"}


def make_coco_tree(root: str, split: str = "val", num_images: int = 8,
                   seed: int = 0, num_fg: int = 80,
                   size_range=(200, 400)) -> str:
    """Write a COCO-layout tree under `root`: JPEGImages/<sub>/<name>.jpg
    (PNG bytes) and SegmentationClass/<sub>/<id>.png palette masks, whose
    blobs take classes 1..num_fg and whose top rows hold the ignore value
    255, for the split's subset <sub> (train or val), and splits/<split>.txt
    listing the names; returns the split dir. No cls_labels.npz: the
    readers derive the labels from the masks."""
    sub = "train" if "train" in split else "val"
    img_dir = os.path.join(root, "JPEGImages", sub)
    lab_dir = os.path.join(root, "SegmentationClass", sub)
    split_dir = os.path.join(root, "splits")
    for d in (img_dir, lab_dir, split_dir):
        os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    palette = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    names = []
    for i in range(num_images):
        stem = f"{i + 1:012d}"
        name = COCO_PREFIX[sub] + stem
        image, label = _draw_sample(rng, size_range, num_fg)
        label[:int(rng.integers(1, 8))] = 255
        write_png(os.path.join(img_dir, name + ".jpg"), image)
        write_png(os.path.join(lab_dir, stem + ".png"), label, palette)
        names.append(name)
    with open(os.path.join(split_dir, split + ".txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return split_dir
