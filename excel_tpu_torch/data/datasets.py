"""VOC / COCO dataset readers (the port's copy of
excel_tpu/data/datasets.py, without the training-view `ClsCropDataset`).

Plain-Python readers producing numpy samples. Layout:

VOC  root/JPEGImages/<name>.jpg, root/SegmentationClassAug/<name>.png
COCO root/JPEGImages/{train,val}/<name>.jpg,
     root/SegmentationClass/{train,val}/<mask>.png where mask = name[15:]
     (train) / name[13:] (val): the COCO_train2014_ / COCO_val2014_ prefix.

Image-level labels come from <split_dir>/cls_labels.npz (name -> one-hot
over fg classes), else from the mask; the test split fakes its label from
the image's red channel. `read_image` and `read_label` tell the format
from the file's signature, as Pillow does: PNG through the port's own
codec (data/png.py), any other format through Pillow when it is installed.
"""
from __future__ import annotations

import os

import numpy as np

from .png import decode_png, is_png


def load_name_list(path: str) -> list[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def load_cls_labels(path: str) -> dict[str, np.ndarray]:
    z = np.load(path, allow_pickle=False)
    return {str(n): l for n, l in zip(z["names"], z["labels"])}


def _read(path: str):
    """(pixels, palette) of a PNG, or a Pillow image of anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if is_png(data):
        return decode_png(data)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path}: not a PNG file, and Pillow, which would decode it, is "
            "not installed (the port decodes PNG only)") from None
    return Image.open(path)


def read_image(path: str) -> np.ndarray:
    """uint8 [h, w, 3] RGB: greyscale stacked, palette indices looked up,
    alpha dropped (Pillow's convert("RGB"))."""
    img = _read(path)
    if not isinstance(img, tuple):
        return np.asarray(img.convert("RGB"))
    pixels, palette = img
    if palette is not None:
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette
        return full[pixels]
    if pixels.ndim == 2:
        return np.repeat(pixels[:, :, None], 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


def read_label(path: str) -> np.ndarray:
    """The mask's stored values: palette indices for a palette PNG."""
    img = _read(path)
    return img[0] if isinstance(img, tuple) else np.asarray(img)


class VocDataset:
    """Base reader; stage 'train'/'val' read SegmentationClassAug masks,
    'test' fakes the label from the red channel."""

    num_fg = 20

    def __init__(self, root_dir: str, split_dir: str, split: str = "train_aug",
                 stage: str = "train"):
        self.root_dir = root_dir
        self.stage = stage
        self.img_dir = os.path.join(root_dir, "JPEGImages")
        self.label_dir = os.path.join(root_dir, "SegmentationClassAug")
        self.name_list = load_name_list(os.path.join(split_dir, split + ".txt"))
        cls_path = os.path.join(split_dir, "cls_labels.npz")
        self.cls_labels = (load_cls_labels(cls_path)
                           if os.path.exists(cls_path) else {})

    def __len__(self):
        return len(self.name_list)

    def label_path(self, name: str) -> str:
        return os.path.join(self.label_dir, name + ".png")

    def read(self, idx: int):
        name = self.name_list[idx]
        image = read_image(os.path.join(self.img_dir, name + ".jpg"))
        if self.stage == "test":
            label = image[:, :, 0]
        else:
            label = read_label(self.label_path(name))
        return name, image, label

    def cls_label_of(self, name: str, label: np.ndarray) -> np.ndarray:
        if name in self.cls_labels:
            return self.cls_labels[name].astype(np.float32)
        present = np.unique(label)
        present = present[(present != 0) & (present != 255)]
        onehot = np.zeros(self.num_fg, np.float32)
        onehot[present.astype(int) - 1] = 1.0
        return onehot


class CocoDataset(VocDataset):
    num_fg = 80

    def __init__(self, root_dir: str, split_dir: str, split: str = "train",
                 stage: str = "train"):
        super().__init__(root_dir, split_dir, split, stage)
        sub = "train" if "train" in split else "val"
        self.img_dir = os.path.join(root_dir, "JPEGImages", sub)
        self.label_dir = os.path.join(root_dir, "SegmentationClass", sub)
        self._prefix = 15 if sub == "train" else 13

    def label_path(self, name: str) -> str:
        return os.path.join(self.label_dir, name[self._prefix:] + ".png")


class EvalDataset:
    """Validation-view dataset: full-size image + label, no augmentation
    (the eval sweeps resize as each protocol requires)."""

    def __init__(self, base: VocDataset):
        self.base = base

    def __len__(self):
        return len(self.base)

    def names(self) -> list[str]:
        """Sample names without decoding any image (index-aligned)."""
        return list(self.base.name_list)

    def __getitem__(self, idx: int):
        name, image, label = self.base.read(idx)
        cls_label = self.base.cls_label_of(name, label)
        return dict(name=name, image=image,
                    label=label.astype(np.int32), cls_label=cls_label)


def make_dataset(cfg_data, split: str, stage: str) -> VocDataset:
    cls = VocDataset if "voc" in cfg_data.dataset else CocoDataset
    return cls(cfg_data.root_dir, cfg_data.split_dir, split, stage)
