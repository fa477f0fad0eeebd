"""Re-score saved prediction PNGs against the ground truth, without a model
run (counterpart of excel_tpu/cli/rescore.py). The PNGs are read by the
port's own codec; the confusion hist is kept on --device.

    python -m excel_tpu_torch.cli.rescore --dataset voc \
        --data-root /data/VOC2012 --pred-dir work_dirs/run/preds
"""
from __future__ import annotations

import argparse
import os

import torch

from ..data.png import read_png
from ..device import resolve_device
from ..utils.logutils import setup_logger
from ..utils.metrics import (format_metrics_table, init_hist,
                             scores_from_hist, update_hist)
from .common import add_common_args, eval_dataset, resolve_config, score_names


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(ap)
    ap.add_argument("--pred-dir", required=True)
    ap.add_argument("--split", default=None)
    ap.add_argument("--suffix", default="",
                    help="prediction filename suffix (e.g. _crf)")
    args = ap.parse_args(argv)

    logger = setup_logger()
    device = resolve_device(args.device)
    cfg = resolve_config(args)
    dataset = eval_dataset(cfg, split=args.split)

    hist = init_hist(cfg.num_classes, device)
    scored = missing = 0
    for i in range(len(dataset)):
        s = dataset[i]
        path = os.path.join(args.pred_dir, s["name"] + args.suffix + ".png")
        if not os.path.exists(path):
            missing += 1
            continue
        pred = torch.from_numpy(read_png(path)[0].astype("int32"))
        hist = update_hist(hist, torch.from_numpy(s["label"]).to(device),
                           pred.to(device), cfg.num_classes)
        scored += 1
    if missing:
        logger.info("WARNING: %d/%d predictions missing", missing,
                    len(dataset))
    scores = scores_from_hist(hist)
    logger.info("re-scored %d preds:\n%s", scored,
                format_metrics_table(scores, score_names(cfg)))
    return scores


if __name__ == "__main__":
    main()
