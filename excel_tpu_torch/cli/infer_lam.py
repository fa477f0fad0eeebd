"""LAM pseudo-label evaluation on the GPU (counterpart of
excel_tpu/cli/infer_lam.py).

    # training-free (no checkpoint)
    python -m excel_tpu_torch.cli.infer_lam --dataset voc \
        --data-root /data/VOC2012 --clip-params clip_vit_b16.npz \
        --training-free [--crf-tpu] [--fast]

    # trained (flip-fused LVC-calibrated LAMs)
    python -m excel_tpu_torch.cli.infer_lam ... --head head_30000.npz

    # on the CPU (the kernels' plain versions), a synthetic tree
    python -m excel_tpu_torch.cli.infer_lam --device cpu --tiny \
        --random-init --synthetic 4 --training-free

CAM overlays (--save-cam, --save-cls-cam) are written as PNG files by the
port's own encoder. The host lattice CRF (--crf and its --crf-stream,
--crf-workers, --save-preds) is not ported yet: those flags exit with an
error; --crf-tpu runs the on-device mean-field CRF.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from ..data.png import write_png
from ..engine.checkpoint import load_head_npz
from ..engine.evaluate import run_lam_eval
from ..models.excel import init_excel_params
from ..utils.logutils import log_sweep_rate, setup_logger
from ..utils.metrics import format_metrics_table
from ..utils.visual import cam_overlay
from .common import (add_common_args, add_eval_gate_args, add_host_crf_args,
                     check_expected_miou, eval_dataset, refuse_host_crf,
                     resolve, score_names)


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
    ap.add_argument("--crf-tpu", action="store_true",
                    help="the on-device conv mean-field CRF branch inside "
                         "the sweep; reports crf_tpu_seg_score")
    ap.add_argument("--crf-tpu-long-range", dest="crf_tpu_lr",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="override CrfConfig.long_range for --crf-tpu")
    add_host_crf_args(ap)
    ap.add_argument("--save-preds", action="store_true",
                    help="not ported: the host CRF's label maps (--crf)")
    add_eval_gate_args(ap)
    args = ap.parse_args(argv)
    refuse_host_crf(ap, args, also=("--save-preds",))

    logger = setup_logger()
    cfg, clip_params, text_attr = resolve(args)
    device = text_attr.device
    if args.crf_tpu_lr is not None:
        cfg = dataclasses.replace(
            cfg, crf=dataclasses.replace(cfg.crf, long_range=args.crf_tpu_lr))
    dataset = eval_dataset(cfg, split=args.split)
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

    t0 = time.perf_counter()
    scores = run_lam_eval(params, dataset, text_attr, cfg, mode=mode,
                          batch_size=batch, progress=progress,
                          save_cam=save_cam, crf_tpu=args.crf_tpu,
                          checkpoint_path=args.hist_ckpt, device=device)
    crf_tpu_scores = None
    if args.crf_tpu:
        scores, crf_tpu_scores = scores
    log_sweep_rate(logger, len(dataset), t0)
    logger.info("Training_free:%s, LAM_score:\n%s", args.training_free,
                format_metrics_table(scores, names,
                                     metrics=("confusion", "precision",
                                              "recall", "iou")))
    if crf_tpu_scores is not None:
        logger.info("crf_tpu_seg_score (on-device mean-field CRF):\n%s",
                    format_metrics_table(crf_tpu_scores, names))
        check_expected_miou(args, crf_tpu_scores, logger)
        return scores, crf_tpu_scores
    check_expected_miou(args, scores, logger)
    return scores


if __name__ == "__main__":
    main()
