"""Image-level one-hot label files from segmentation masks (counterpart of
tools/make_cls_labels.py).

The reference ships pickled dicts (datasets/voc/cls_labels_onehot.npy; the
COCO one is a missing large blob in the snapshot). This writes the
equivalent `cls_labels.npz` (names + [N, num_fg] uint8) for any dataset in
VOC or COCO layout by scanning the masks of the given splits: the same
derivation as VOC12ClsDataset._to_onehot (reference datasets/voc.py:119-133).
The masks are read by the port's own PNG codec (`data/datasets.read_label`);
the tool runs on the host and needs no device.

    python -m excel_tpu_torch.cli.make_cls_labels --dataset voc \
        --data-root /data/VOC2012 --splits train_aug val \
        --out assets/splits/voc/cls_labels.npz
"""
from __future__ import annotations

import argparse

import numpy as np

from ..config import asset_path
from ..data.datasets import CocoDataset, VocDataset, read_label


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", choices=["voc", "coco"], required=True)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--split-dir", default=None)
    ap.add_argument("--splits", nargs="+", required=True)
    ap.add_argument("--num-fg", type=int, default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    split_dir = args.split_dir or asset_path("splits", args.dataset)
    cls = VocDataset if args.dataset == "voc" else CocoDataset
    names, onehots = [], []
    for split in args.splits:
        ds = cls(args.data_root, split_dir, split, "train")
        num_fg = args.num_fg or ds.num_fg
        for i in range(len(ds)):
            name = ds.name_list[i]
            label = read_label(ds.label_path(name))
            present = np.unique(label)
            present = present[(present > 0) & (present != 255)]
            onehot = np.zeros(num_fg, np.uint8)
            onehot[present.astype(int) - 1] = 1
            names.append(name)
            onehots.append(onehot)
            if (i + 1) % 1000 == 0:
                print(f"{split}: {i + 1}/{len(ds)}")
    np.savez(args.out, names=np.asarray(names), labels=np.stack(onehots))
    print(f"{len(names)} entries -> {args.out}")


if __name__ == "__main__":
    main()
