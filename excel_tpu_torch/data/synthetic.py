"""Synthetic mini-dataset generator in the VOC directory layout (the port's
copy of excel_tpu/data/synthetic.py).

The same arrays from the same numpy generator as the JAX package's
`make_voc_tree`: coloured elliptical blobs on a textured background, with
exact segmentation masks. One difference of form: each image is stored
losslessly as PNG bytes under the layout's `JPEGImages/<name>.jpg` name
(the machine with the card has no JPEG decoder, and a lossless image makes
every reader see the same pixels). Readers that detect the format from the
file's signature (Pillow, `datasets.read_image`) read it as it is.
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
