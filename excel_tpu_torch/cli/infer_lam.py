"""LAM pseudo-label evaluation on the GPU (counterpart of
excel_tpu/cli/infer_lam.py).

    # training-free (no checkpoint)
    python -m excel_tpu_torch.cli.infer_lam --dataset voc \
        --data-root /data/VOC2012 --clip-params clip_vit_b16.npz \
        --training-free [--crf | --crf-tpu] [--fast]

    # trained (flip-fused LVC-calibrated LAMs)
    python -m excel_tpu_torch.cli.infer_lam ... --head head_30000.npz

    # on the CPU (the kernels' plain versions), a synthetic tree
    python -m excel_tpu_torch.cli.infer_lam --device cpu --tiny \
        --random-init --synthetic 4 --training-free

CAM overlays (--save-cam, --save-cls-cam) are written as PNG files by the
port's own encoder. --crf is the reference's protocol: the sweep spills
each image's background and present-class cams to work_dir/lam_logits/,
the host lattice CRF refines them (after the sweep, or beside it with
--crf-stream) and crf_seg_score scores the refined labels; --save-preds
writes those labels to work_dir/crf_preds/. --crf-tpu runs the on-device
mean-field CRF inside the sweep instead.

Under torchrun (one process a device; `--dist-backend gloo --device cuda:0`
for ranks that share one card) each rank sweeps its round-robin shard of
the images, the scores (the device CRF's and the host CRF's too) are those
of the hists summed over the ranks, and rank 0 alone logs the tables.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from ..data.png import write_png
from ..engine.checkpoint import load_head_npz
from ..engine.crf_post import lam_spiller
from ..engine.evaluate import run_lam_eval
from ..models.excel import init_excel_params
from ..parallel import is_primary
from ..parallel.distributed import shard_dataset
from ..utils.logutils import log_sweep_rate, setup_logger
from ..utils.metrics import format_metrics_table
from ..utils.visual import cam_overlay, save_palette_png
from .common import (add_common_args, add_eval_gate_args,
                     check_expected_miou, eval_dataset, host_crf_hook,
                     host_crf_scores, resolve, score_names)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(ap)
    ap.add_argument("--training-free", action="store_true")
    ap.add_argument("--head", default=None, help="trained head .npz")
    ap.add_argument("--split", default=None)
    ap.add_argument("--save-cam", action="store_true",
                    help="write CAM overlays (max over classes) as PNG to "
                         "work_dir/cams/")
    ap.add_argument("--save-cls-cam", action="store_true",
                    help="per-class CAM overlays instead of the max")
    ap.add_argument("--crf", action="store_true",
                    help="the reference's host CRF protocol: spill each "
                         "image's background + present-class normed cams "
                         "and their keys to work_dir/lam_logits/, refine "
                         "them with the host lattice dense CRF, map the "
                         "argmax back through the keys, report "
                         "crf_seg_score")
    ap.add_argument("--crf-workers", type=int, default=None,
                    help="the CRF's thread-pool width (default 0.6 x "
                         "cpu_count, the reference's joblib sizing)")
    ap.add_argument("--crf-stream", action="store_true",
                    help="run the host CRF beside the device sweep (each "
                         "image submitted as its cams spill): the same "
                         "scores, wall about max(sweep, CRF) on a host "
                         "with cores to spare")
    ap.add_argument("--crf-tpu", action="store_true",
                    help="the on-device conv mean-field CRF branch inside "
                         "the sweep (no spill, no host lattice; approximates "
                         "--crf); reports crf_tpu_seg_score")
    ap.add_argument("--crf-tpu-long-range", dest="crf_tpu_lr",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="override CrfConfig.long_range for --crf-tpu")
    ap.add_argument("--save-preds", action="store_true",
                    help="with --crf: write the CRF-refined label maps as "
                         "palette PNGs to work_dir/crf_preds/")
    add_eval_gate_args(ap)
    args = ap.parse_args(argv)
    if ((args.crf_stream or args.crf_workers is not None
         or args.save_preds) and not args.crf):
        ap.error("--crf-stream/--crf-workers/--save-preds require --crf "
                 "(the host lattice pass)")

    logger = setup_logger()
    cfg, clip_params, text_attr = resolve(args)
    device = text_attr.device
    if args.crf_tpu_lr is not None:
        cfg = dataclasses.replace(
            cfg, crf=dataclasses.replace(cfg.crf, long_range=args.crf_tpu_lr))
    dataset = shard_dataset(eval_dataset(cfg, split=args.split))
    batch = args.batch_size or 4

    if args.training_free:
        params, mode = {"clip": clip_params}, "training_free"
    else:
        if args.head:
            head = load_head_npz(args.head, cfg.head, cfg.num_classes, device)
            params = {"clip": clip_params, "head": head}
        elif args.random_init:
            params = init_excel_params(cfg, clip_params,
                                       torch.Generator().manual_seed(0),
                                       device)
        else:
            raise SystemExit("trained mode needs --head (or --training-free)")
        mode = "trained"
    logger.info("LAM eval: mode=%s, %d images, device %s", mode,
                len(dataset), device)
    done = [0]

    def progress(n):
        done[0] += n
        if done[0] % (50 * batch) < batch:
            logger.info("  %d / %d", done[0], len(dataset))

    names = score_names(cfg)
    save_cam = None
    if args.save_cam or args.save_cls_cam:
        cam_dir = os.path.join(args.work_dir, "cams")
        os.makedirs(cam_dir, exist_ok=True)

        def save_cam(name, image, cams):
            fg = cams[1:]
            if args.save_cls_cam:
                for ci, cam in enumerate(fg):
                    if cam.max() > 0:
                        write_png(os.path.join(
                            cam_dir, f"{name}_{names[ci + 1]}.png"),
                            cam_overlay(image, cam))
            else:
                write_png(os.path.join(cam_dir, name + ".png"),
                          cam_overlay(image, fg.max(axis=0)))

    lam_logits_dir = os.path.join(args.work_dir, "lam_logits")
    save_lam_crf = post = crf_save_pred = None
    if args.crf:
        if args.save_preds:
            pred_dir = os.path.join(args.work_dir, "crf_preds")
            os.makedirs(pred_dir, exist_ok=True)

            def crf_save_pred(name, pred):
                save_palette_png(pred, os.path.join(pred_dir, name + ".png"),
                                 num_classes=cfg.num_classes)

        save_lam_crf, post = host_crf_hook(
            args, cfg, dataset, lam_logits_dir, "lam",
            lam_spiller(lam_logits_dir), crf_save_pred)

    t0 = time.perf_counter()
    scores = run_lam_eval(params, dataset, text_attr, cfg, mode=mode,
                          batch_size=batch, progress=progress,
                          save_cam=save_cam, save_lam_crf=save_lam_crf,
                          crf_tpu=args.crf_tpu,
                          checkpoint_path=args.hist_ckpt, device=device)
    crf_tpu_scores = None
    if args.crf_tpu:
        scores, crf_tpu_scores = scores
    log_sweep_rate(logger, len(dataset), t0)
    if is_primary():
        logger.info("Training_free:%s, LAM_score:\n%s", args.training_free,
                    format_metrics_table(scores, names,
                                         metrics=("confusion", "precision",
                                                  "recall", "iou")))
    if crf_tpu_scores is not None and is_primary():
        logger.info("crf_tpu_seg_score (on-device mean-field CRF):\n%s",
                    format_metrics_table(crf_tpu_scores, names))

    if args.crf:
        crf_scores = host_crf_scores(args, cfg, dataset, lam_logits_dir,
                                     "lam", post, crf_save_pred, logger)
        check_expected_miou(args, crf_scores, logger)
        return scores, crf_scores
    if crf_tpu_scores is not None:
        check_expected_miou(args, crf_tpu_scores, logger)
        return scores, crf_tpu_scores
    check_expected_miou(args, scores, logger)
    return scores


if __name__ == "__main__":
    main()
