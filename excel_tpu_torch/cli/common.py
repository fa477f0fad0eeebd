"""Shared CLI plumbing of the port (counterpart of excel_tpu/cli/common.py):
config resolution, weights, the text bank, the synthetic dataset.

One process on one device: `--device` (default cuda) picks it, and a cuda
request on a machine without a GPU raises. The JAX package's multi-host
initialisation and mesh have no counterpart yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from ..config import (ExcelConfig, asset_path, coco_config, fast,
                      tiny_config, voc_config)
from ..data.datasets import EvalDataset, make_dataset
from ..device import resolve_device
from ..models.excel import build_text_bank
from ..models.params import (cast_matmul_weights, init_clip_params,
                             load_params_npz)
from ..ops.tse import load_attr_bank
from ..text.class_names import class_list, prompt_vocabulary


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
                    help="cuda (the CUDA kernels) or cpu (their plain "
                         "PyTorch versions)")


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


# the host lattice CRF flags of the JAX package's eval CLIs
HOST_CRF_FLAGS = ("--crf", "--crf-stream", "--crf-workers", "--crf-scale")


def add_host_crf_args(ap: argparse.ArgumentParser) -> None:
    """The host lattice CRF's flags, which the port refuses until it has
    that CRF; --crf-tpu runs the on-device mean-field CRF."""
    for flag in HOST_CRF_FLAGS:
        ap.add_argument(flag, default=None, nargs="?", const=True,
                        help="not ported: the host lattice CRF "
                             "(ROADMAP.md module item 5); see --crf-tpu")


def refuse_host_crf(ap: argparse.ArgumentParser, args,
                    also: tuple[str, ...] = ()) -> None:
    given = [f for f in HOST_CRF_FLAGS + also
             if getattr(args, f[2:].replace("-", "_"), None)
             not in (None, False)]
    if given:
        ap.error(f"{'/'.join(given)}: the host lattice CRF is not ported "
                 "yet (ROADMAP.md module item 5, host CRF); --crf-tpu runs "
                 "the on-device mean-field CRF")


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
    it) and point cfg.data at it."""
    from ..data.synthetic import make_voc_tree

    root = os.path.join(args.work_dir, "synthetic_data")
    size_range = ((48, 96) if args.tiny else (200, 400))
    marker = os.path.join(root, ".complete")
    # the marker carries the generation parameters: a rerun with another
    # size / seed / class count regenerates rather than reusing stale data
    spec = (f"{int(args.synthetic)}:{cfg.train.seed}:{cfg.num_fg}:"
            f"{size_range}")
    try:
        with open(marker) as f:
            reuse = f.read() == spec
    except OSError:
        reuse = False
    if reuse:
        split_dir = os.path.join(root, "splits")
    else:
        split_dir = make_voc_tree(root, num_images=int(args.synthetic),
                                  seed=cfg.train.seed, num_fg=cfg.num_fg,
                                  size_range=size_range)
        with open(marker, "w") as f:
            f.write(spec)
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
    """(cfg, clip_params, text_attr) on args.device. The text bank is built
    from the uncast weights in the preset's compute type; then, in bf16,
    the matmul weights are cast once."""
    device = resolve_device(args.device)
    exact_matmuls()
    cfg = resolve_config(args)
    clip_params = load_clip(args, cfg, device)
    text_attr = load_text_bank(args, cfg, clip_params, device)
    if cfg.clip.compute_dtype == torch.bfloat16:
        clip_params = cast_matmul_weights(clip_params, torch.bfloat16)
    return cfg, clip_params, text_attr


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
