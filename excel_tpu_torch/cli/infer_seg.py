"""MSC+flip segmentation evaluation on the GPU, optionally with the
on-device mean-field CRF (counterpart of excel_tpu/cli/infer_seg.py).

    python -m excel_tpu_torch.cli.infer_seg --dataset voc \
        --data-root /data/VOC2012 --clip-params clip_vit_b16.npz \
        --head head_30000.npz [--crf-tpu] [--save-preds] [--fast]

--save-preds writes palette PNGs (the VOC evaluation server's format) to
work_dir/preds/, which `rescore` reads. The host lattice CRF (--crf,
--crf-scale, --crf-stream, --crf-workers) is not ported yet: those flags
exit with an error.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from ..engine.checkpoint import load_head_npz
from ..engine.evaluate import run_msc_seg_eval
from ..models.excel import init_excel_params
from ..utils.logutils import log_sweep_rate, setup_logger
from ..utils.metrics import format_metrics_table
from ..utils.visual import save_palette_png
from .common import (add_common_args, add_eval_gate_args, add_host_crf_args,
                     check_expected_miou, eval_dataset, refuse_host_crf,
                     resolve, score_names)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(ap)
    ap.add_argument("--head", default=None, help="trained head .npz")
    ap.add_argument("--split", default=None)
    ap.add_argument("--scales", default="1.0,0.7,1.2,1.5",
                    help="MSC scales (x crop size)")
    ap.add_argument("--crf-tpu", action="store_true",
                    help="the on-device convolutional mean-field CRF on the "
                         "fused logits before the argmax")
    ap.add_argument("--crf-tpu-long-range", dest="crf_tpu_lr",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="override CrfConfig.long_range for --crf-tpu")
    ap.add_argument("--save-preds", action="store_true",
                    help="write palette PNGs (VOC server format) to "
                         "work_dir/preds/")
    add_host_crf_args(ap)
    add_eval_gate_args(ap)
    args = ap.parse_args(argv)
    refuse_host_crf(ap, args)

    logger = setup_logger()
    cfg, clip_params, text_attr = resolve(args)
    device = text_attr.device
    if args.crf_tpu_lr is not None:
        cfg = dataclasses.replace(
            cfg, crf=dataclasses.replace(cfg.crf, long_range=args.crf_tpu_lr))
    stage = "test" if args.split == "test" else "val"
    dataset = eval_dataset(cfg, split=args.split, stage=stage)
    batch = args.batch_size or 4
    scales = tuple(float(s) for s in args.scales.split(","))

    if args.head:
        params = {"clip": clip_params,
                  "head": load_head_npz(args.head, cfg.head, cfg.num_classes,
                                        device)}
    elif args.random_init:
        params = init_excel_params(cfg, clip_params,
                                   torch.Generator().manual_seed(0), device)
    else:
        raise SystemExit("--head required (or --random-init for smoke)")

    pred_dir = os.path.join(args.work_dir, "preds")

    def save_pred(name, label):
        os.makedirs(pred_dir, exist_ok=True)
        save_palette_png(label, os.path.join(pred_dir, name + ".png"),
                         num_classes=cfg.num_classes)

    logger.info("MSC+flip seg eval: scales=%s, %d images, device %s",
                scales, len(dataset), device)
    t0 = time.perf_counter()
    scores = run_msc_seg_eval(
        params, dataset, text_attr, cfg, scales=scales, batch_size=batch,
        save_pred=save_pred if args.save_preds else None,
        crf_tpu=args.crf_tpu, checkpoint_path=args.hist_ckpt, device=device)
    log_sweep_rate(logger, len(dataset), t0)
    logger.info("raw_seg_score:\n%s",
                format_metrics_table(scores, score_names(cfg),
                                     metrics=("confusion", "precision",
                                              "recall", "iou")))
    check_expected_miou(args, scores, logger)
    return scores


if __name__ == "__main__":
    main()
