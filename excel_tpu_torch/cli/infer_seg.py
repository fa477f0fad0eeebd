"""MSC+flip segmentation evaluation on the GPU, optionally with a dense CRF
(counterpart of excel_tpu/cli/infer_seg.py).

    python -m excel_tpu_torch.cli.infer_seg --dataset voc \
        --data-root /data/VOC2012 --clip-params clip_vit_b16.npz \
        --head head_30000.npz [--crf | --crf-tpu] [--save-preds] [--fast]

--save-preds writes palette PNGs (the VOC evaluation server's format) to
work_dir/preds/, which `rescore` reads; with --crf also the host CRF's maps
as <name>_crf.png. --crf is the reference's protocol: the sweep spills each
image's pre-CRF logits to work_dir/logits/ and the host lattice CRF scores
them (after the sweep, or beside it with --crf-stream). --crf-tpu runs the
on-device mean-field CRF inside the sweep instead.

Under torchrun (one process a device; `--dist-backend gloo --device cuda:0`
for ranks that share one card) each rank sweeps its round-robin shard of
the images, the scores (the host CRF's too) are those of the hists summed
over the ranks, and rank 0 alone logs the tables.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from ..engine.checkpoint import load_head_npz
from ..engine.crf_post import seg_logit_spiller
from ..engine.evaluate import run_msc_seg_eval
from ..models.excel import init_excel_params
from ..parallel import is_primary
from ..parallel.distributed import shard_dataset
from ..utils.logutils import log_sweep_rate, setup_logger
from ..utils.metrics import format_metrics_table
from ..utils.visual import save_palette_png
from .common import (add_common_args, add_eval_gate_args,
                     check_expected_miou, eval_dataset, host_crf_hook,
                     host_crf_scores, resolve, score_names)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(ap)
    ap.add_argument("--head", default=None, help="trained head .npz")
    ap.add_argument("--split", default=None)
    ap.add_argument("--scales", default="1.0,0.7,1.2,1.5",
                    help="MSC scales (x crop size)")
    ap.add_argument("--crf", action="store_true",
                    help="the host lattice dense CRF over the pre-CRF fused "
                         "logits (the reference's protocol): the sweep "
                         "spills one npy an image to work_dir/logits/, "
                         "then a thread pool streams them through the "
                         "lattice with bounded memory")
    ap.add_argument("--crf-scale", type=float, default=None,
                    help="spill the logits at this fraction of the label "
                         "resolution (a disk bound; the CRF pass upsamples "
                         "them before the softmax). Default 1.0, and 0.2 "
                         "for COCO, the reference's disk bound")
    ap.add_argument("--crf-workers", type=int, default=None,
                    help="the CRF's thread-pool width (default 0.6 x "
                         "cpu_count, the reference's joblib sizing)")
    ap.add_argument("--crf-stream", action="store_true",
                    help="run the host CRF beside the device sweep (each "
                         "image submitted as its logits spill): the same "
                         "scores, wall about max(sweep, CRF) instead of "
                         "their sum on a host with cores to spare")
    ap.add_argument("--crf-tpu", action="store_true",
                    help="the on-device convolutional mean-field CRF on the "
                         "fused logits before the argmax; affects "
                         "raw_seg_score and --save-preds only: with --crf "
                         "the host pass still takes the pre-CRF logits")
    ap.add_argument("--crf-tpu-long-range", dest="crf_tpu_lr",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="override CrfConfig.long_range for --crf-tpu")
    ap.add_argument("--save-preds", action="store_true",
                    help="write palette PNGs (VOC server format) to "
                         "work_dir/preds/; with --crf also the host CRF's "
                         "as <name>_crf.png")
    add_eval_gate_args(ap)
    args = ap.parse_args(argv)
    if (args.crf_stream or args.crf_workers is not None) and not args.crf:
        ap.error("--crf-stream/--crf-workers require --crf (the host "
                 "lattice pass); --crf-tpu runs inside the sweep instead")

    logger = setup_logger()
    cfg, clip_params, text_attr = resolve(args)
    device = text_attr.device
    if args.crf_tpu_lr is not None:
        cfg = dataclasses.replace(
            cfg, crf=dataclasses.replace(cfg.crf, long_range=args.crf_tpu_lr))
    stage = "test" if args.split == "test" else "val"
    dataset = shard_dataset(eval_dataset(cfg, split=args.split, stage=stage))
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

    logits_dir = os.path.join(args.work_dir, "logits")
    save_crf_pred = ((lambda n, p: save_pred(n + "_crf", p))
                     if args.save_preds else None)
    save_logits = post = None
    if args.crf:
        crf_scale = args.crf_scale
        if crf_scale is None:
            # the reference's disk bound: COCO logits spill at 0.2 x the
            # label resolution (tools/infer_seg_coco.py:62-64), VOC's at 1
            crf_scale = 0.2 if args.dataset == "coco" else 1.0
        save_logits, post = host_crf_hook(
            args, cfg, dataset, logits_dir, "seg",
            seg_logit_spiller(logits_dir, scale=crf_scale), save_crf_pred)

    logger.info("MSC+flip seg eval: scales=%s, %d images, device %s",
                scales, len(dataset), device)
    t0 = time.perf_counter()
    scores = run_msc_seg_eval(
        params, dataset, text_attr, cfg, scales=scales, batch_size=batch,
        save_pred=save_pred if args.save_preds else None,
        save_logits=save_logits, crf_tpu=args.crf_tpu,
        checkpoint_path=args.hist_ckpt, device=device)
    log_sweep_rate(logger, len(dataset), t0)
    if is_primary():
        logger.info("raw_seg_score:\n%s",
                    format_metrics_table(scores, score_names(cfg),
                                         metrics=("confusion", "precision",
                                                  "recall", "iou")))
    if not args.crf:
        check_expected_miou(args, scores, logger)
        return scores

    crf_scores = host_crf_scores(args, cfg, dataset, logits_dir, "seg",
                                 post, save_crf_pred, logger)
    check_expected_miou(args, crf_scores, logger)
    return scores, crf_scores


if __name__ == "__main__":
    main()
