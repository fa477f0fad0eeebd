"""Shared CLI plumbing of the port (counterpart of excel_tpu/cli/common.py):
config resolution, weights, the text bank, the synthetic dataset.

One process a device: `--device` (default cuda) picks it, and a cuda
request on a machine without a GPU raises. Under torchrun (one process a
device) `resolve` first joins the process group (parallel.initialize):
"cuda" is then the rank's own card, and `--dist-backend gloo` lets ranks
share one card, named with its index (`--device cuda:0`).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..config import (ExcelConfig, asset_path, coco_config, fast,
                      tiny_config, voc_config)
from ..data.datasets import ClsCropDataset, EvalDataset, make_dataset
from ..device import resolve_device
from ..engine.crf_post import (StreamingCrfPost, crf_from_cfg,
                               default_workers, run_crf_post)
from ..models.excel import build_text_bank
from ..models.params import (cast_matmul_weights, init_clip_params,
                             load_params_npz)
from ..ops.tse import load_attr_bank
from ..parallel.distributed import (BACKENDS, barrier, global_sum_host,
                                    initialize, is_primary)
from ..text.class_names import class_list, prompt_vocabulary
from ..utils.logutils import log_sweep_rate
from ..utils.metrics import format_metrics_table, scores_from_hist


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--dataset", default="voc", choices=["voc", "coco"])
    ap.add_argument("--data-root", default=None,
                    help="dataset root (VOC2012 / coco2014 layout)")
    ap.add_argument("--split-dir", default=None,
                    help="split-list dir (default: bundled assets)")
    ap.add_argument("--clip-params", default=None,
                    help="CLIP weights .npz in the JAX package's "
                         "save_params_npz format")
    ap.add_argument("--random-init", action="store_true",
                    help="random weights + random text bank (smoke runs)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model config (CI / smoke)")
    ap.add_argument("--fast", action="store_true",
                    help="bf16 production preset (fp32 by default)")
    ap.add_argument("--synthetic", default=None, metavar="N",
                    help="generate an N-image synthetic dataset instead of "
                         "reading --data-root")
    ap.add_argument("--work-dir", default="work_dirs/run")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels; under torchrun the "
                         "rank's own card) or cpu (their plain PyTorch "
                         "versions)")
    ap.add_argument("--dist-backend", default=None, choices=BACKENDS,
                    help="the process group's backend under torchrun "
                         "(default: nccl for cuda, gloo for cpu); gloo for "
                         "ranks that share one card (--device cuda:0); "
                         "given at world size 1, it forms a group of one")


def add_eval_gate_args(ap: argparse.ArgumentParser) -> None:
    """Flags shared by the eval CLIs: the real-assets mIoU gate and
    resumable-sweep hist checkpointing."""
    ap.add_argument("--expect-miou", type=float, default=None,
                    help="exit nonzero unless the final mIoU (%%) is within "
                         "--miou-tol of this")
    ap.add_argument("--miou-tol", type=float, default=0.3)
    ap.add_argument("--hist-ckpt", default=None,
                    help="periodic hist checkpoint file; rerunning with the "
                         "same protocol resumes a killed sweep")


def host_crf_hook(args, cfg: ExcelConfig, dataset, logits_dir: str,
                  kind: str, spill, save_pred):
    """-> (the sweep's spill hook, the streamed pass or None) for --crf:
    the spiller itself, or with --crf-stream a hook that also submits each
    spilled image to a `StreamingCrfPost`."""
    if not args.crf_stream:
        return spill, None
    post = StreamingCrfPost(dataset, logits_dir, crf_from_cfg(cfg.crf),
                            cfg.num_classes, kind=kind,
                            num_workers=args.crf_workers,
                            save_pred=save_pred)

    def hook(name, *arrays):
        spill(name, *arrays)
        post.submit(name)

    return hook, post


def host_crf_scores(args, cfg: ExcelConfig, dataset, logits_dir: str,
                    kind: str, post, save_pred, logger) -> dict:
    """The host CRF after the sweep: drain the streamed pass `post`, or run
    the post-pass over the spill directory; logs and returns
    crf_seg_score. The hist is the rank's shard's, summed over the
    process group before it is scored."""
    t0 = time.perf_counter()
    if post is not None:
        logger.info("crf post-processing (streamed, draining)...")
        hist = post.finish()
    else:
        workers = args.crf_workers or default_workers()
        logger.info("crf post-processing (%d images, %d threads)...",
                    len(dataset), workers)
        # the eval protocol's parameter set, shared by both CLIs
        # (tools/infer_seg_voc.py:113-120 == tools/infer_lam.py:189-196)
        hist = run_crf_post(dataset, logits_dir, crf_from_cfg(cfg.crf),
                            cfg.num_classes, kind=kind, num_workers=workers,
                            save_pred=save_pred)
    log_sweep_rate(logger, len(dataset), t0)
    crf_scores = scores_from_hist(global_sum_host(hist))
    if is_primary():
        logger.info("crf_seg_score:\n%s",
                    format_metrics_table(crf_scores, score_names(cfg)))
    return crf_scores


def check_expected_miou(args, scores, logger) -> None:
    """--expect-miou gate: exit 3 unless the final mIoU is within
    --miou-tol of the expectation."""
    if getattr(args, "expect_miou", None) is None:
        return
    got = 100.0 * scores["miou"]
    delta = abs(got - args.expect_miou)
    if delta > args.miou_tol:
        logger.error("mIoU %.2f misses expectation %.2f by %.2f (tol %.2f)",
                     got, args.expect_miou, delta, args.miou_tol)
        raise SystemExit(3)
    logger.info("mIoU %.2f within %.2f of expected %.2f: PASS", got,
                args.miou_tol, args.expect_miou)


def build_config(args) -> ExcelConfig:
    if args.tiny:
        cfg = tiny_config()
    elif args.dataset == "coco":
        cfg = coco_config()
    else:
        cfg = voc_config()
    data = cfg.data
    if args.data_root:
        data = dataclasses.replace(data, root_dir=args.data_root)
    if args.split_dir:
        data = dataclasses.replace(data, split_dir=args.split_dir)
    return dataclasses.replace(cfg, data=data)


def load_clip(args, cfg: ExcelConfig, device: torch.device) -> dict:
    if args.clip_params:
        return load_params_npz(args.clip_params, cfg.clip, device)
    if not args.random_init:
        default = asset_path("clip_vit_b16.npz")
        if os.path.exists(default):
            return load_params_npz(default, cfg.clip, device)
        raise SystemExit("no CLIP weights: pass --clip-params (a .npz "
                         "written by save_params_npz) or --random-init")
    return init_clip_params(cfg.clip,
                            torch.Generator().manual_seed(cfg.train.seed),
                            device)


def load_text_bank(args, cfg: ExcelConfig, clip_params,
                   device: torch.device) -> torch.Tensor:
    """Enriched text embeddings: the prompt ensemble of the dataset's
    vocabulary + TSE over the bundled cluster bank; under --random-init the
    JAX package's seeded random bank (num_fg + 3 / 25 / 23 rows for tiny /
    VOC / COCO), the same numbers."""
    if args.random_init:
        rng = np.random.default_rng(cfg.train.seed)
        n_bg = 3 if args.tiny else (25 if args.dataset == "voc" else 23)
        bank = rng.normal(size=(cfg.num_fg + n_bg,
                                cfg.clip.embed_dim)).astype(np.float32)
        bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
        return torch.from_numpy(bank).to(device)
    ds_name = "pascal_voc" if args.dataset == "voc" else "ms_coco"
    cluster_bank, _ = load_attr_bank(asset_path(
        "attributes", f"{ds_name}_bank_{cfg.num_attr_clusters}.npz"), device)
    return build_text_bank(clip_params, cfg, prompt_vocabulary(ds_name),
                           cluster_bank)


def build_synthetic(args, cfg: ExcelConfig) -> ExcelConfig:
    """Generate a synthetic tree under work_dir (or reuse one whose
    completion marker names the same parameters, whichever package wrote
    it) and point cfg.data at it. Under a process group rank 0 alone
    generates it, on the shared work_dir, and the other ranks wait for it
    at a barrier."""
    from ..data.synthetic import make_voc_tree

    root = os.path.join(args.work_dir, "synthetic_data")
    size_range = ((48, 96) if args.tiny else (200, 400))
    marker = os.path.join(root, ".complete")
    # the marker carries the generation parameters: a rerun with another
    # size / seed / class count regenerates rather than reusing stale data
    spec = (f"{int(args.synthetic)}:{cfg.train.seed}:{cfg.num_fg}:"
            f"{size_range}")

    def marker_matches() -> bool:
        try:
            with open(marker) as f:
                return f.read() == spec
        except OSError:
            return False

    if is_primary() and not marker_matches():
        make_voc_tree(root, num_images=int(args.synthetic),
                      seed=cfg.train.seed, num_fg=cfg.num_fg,
                      size_range=size_range)
        with open(marker, "w") as f:
            f.write(spec)
    barrier()
    if not marker_matches():
        raise RuntimeError(f"no synthetic tree for {spec} at {root}")
    split_dir = os.path.join(root, "splits")
    data = dataclasses.replace(cfg.data, root_dir=root, split_dir=split_dir,
                               # synthetic trees always use the VOC layout
                               dataset="synthetic_voc", train_split="train_aug",
                               eval_pad=(96 if args.tiny else cfg.data.eval_pad))
    return dataclasses.replace(cfg, data=data)


def resolve_config(args) -> ExcelConfig:
    """The config of the flags: preset, --fast, --synthetic."""
    cfg = build_config(args)
    if getattr(args, "fast", False):
        cfg = fast(cfg)
    if args.synthetic:
        cfg = build_synthetic(args, cfg)
    return cfg


def exact_matmuls() -> None:
    """fp32 products in fp32 on the card (no TF32) and bf16 products summed
    in fp32, as the CPU and the JAX package compute them; the library sets
    no global flag, its entry points do."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve(args):
    """(cfg, clip_params, text_attr) on args.device, after joining the
    process group where torchrun started this process. The text bank is
    built from the uncast weights in the preset's compute type; then, in
    bf16, the matmul weights are cast once."""
    initialize(args.device, args.dist_backend)
    device = resolve_device(args.device)
    exact_matmuls()
    cfg = resolve_config(args)
    clip_params = load_clip(args, cfg, device)
    text_attr = load_text_bank(args, cfg, clip_params, device)
    if cfg.clip.compute_dtype == torch.bfloat16:
        clip_params = cast_matmul_weights(clip_params, torch.bfloat16)
    return cfg, clip_params, text_attr


def train_dataset(cfg: ExcelConfig) -> ClsCropDataset:
    base = make_dataset(cfg.data, cfg.data.train_split, "train")
    base.num_fg = cfg.num_fg
    return ClsCropDataset(base, crop_size=cfg.data.crop_size,
                          rescale_range=tuple(cfg.data.rescale_range),
                          ignore_index=cfg.data.ignore_index)


def eval_dataset(cfg: ExcelConfig, split: str | None = None,
                 stage: str = "val") -> EvalDataset:
    base = make_dataset(cfg.data, split or cfg.data.val_split, stage)
    base.num_fg = cfg.num_fg
    return EvalDataset(base)


def score_names(cfg: ExcelConfig) -> list[str]:
    """Class names for the score tables (c0, c1, ... on synthetic data)."""
    if "synthetic" in cfg.data.dataset:
        return [f"c{i}" for i in range(cfg.num_classes)]
    return class_list(cfg.data.dataset)
