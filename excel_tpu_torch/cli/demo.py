"""End-to-end demo: training-free LAM pseudo-labels on a synthetic image
(counterpart of tools/demo_pipeline.py).

Runs the frozen-encoder pipeline (surgery-CLIP forward -> feature-surgery
LAMs -> SVC affinity refinement -> PAR -> argmax pseudo-label,
`engine.pipeline.training_free_step`) on `--device` (default cuda: the CUDA
kernels; cpu: their plain PyTorch versions) at voc_config() width, with
random weights drawn from a torch.Generator seeded 0 (or converted weights,
`--params`) and seeded synthetic images. Prints the device, the first
call's time (the kernels' build included) and the steady state's, the label
shape and histogram, and OK.

The images and labels are the JAX demo's (numpy `default_rng(0)`). Its text
bank is `jax.random.normal(PRNGKey(0))`, a stream torch cannot draw: here
the bank is `torch.randn` from a Generator seeded 0, each row L2-normalised.
`run_demo` takes the bank as an argument, so that a test can hand both
packages the same one. `--tiny` runs the tiny test config (the classes
7 and 14 then lie beyond its label set and are dropped).

    python -m excel_tpu_torch.cli.demo                    # the card
    python -m excel_tpu_torch.cli.demo --device cpu --tiny --image-size 64
    python -m excel_tpu_torch.cli.demo --backbone openclip-vit-h-14  # 336 px
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import numpy as np
import torch

from ..config import DEFAULT_BACKBONE, tiny_config, voc_config, with_backbone
from ..device import resolve_device
from ..engine.pipeline import training_free_step
from ..models.params import init_clip_params, load_params_npz
from .common import add_backbone_arg, exact_matmuls

DEMO_CLASSES = (0, 7, 14)


def synthetic_batch(batch: int, size: int, num_fg: int):
    """(uint8 images [B, S, S, 3], one-hot labels [B, num_fg]): coloured
    blobs on noise, as the JAX demo draws them."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 64, (batch, size, size, 3), dtype=np.uint8)
    images[:, 80:220, 60:180] += 150
    cls_label = np.zeros((batch, num_fg), np.float32)
    cls_label[:, [c for c in DEMO_CLASSES if c < num_fg]] = 1.0
    return images, cls_label


def random_text_bank(num_rows: int, dim: int) -> torch.Tensor:
    """L2-normalised rows of torch.randn from a Generator seeded 0."""
    bank = torch.randn(num_rows, dim,
                       generator=torch.Generator().manual_seed(0))
    return bank / torch.linalg.norm(bank, dim=-1, keepdim=True)


def device_line(device: torch.device) -> str:
    if device.type == "cpu":
        return "devices: cpu"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(index)], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        limit = f"not read ({e})"
    return (f"devices: {device} {torch.cuda.get_device_name(index)}, power "
            f"limit {limit}")


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_demo(clip_params: dict, images_u8: np.ndarray, cls_label: np.ndarray,
             text_attr: torch.Tensor, cfg, device):
    """Two calls of `training_free_step` on `device`: (labels [B, S, S]
    int32 numpy of the second call, first call's s, second call's s), each
    timed to a device synchronise."""
    device = torch.device(device)
    images = torch.from_numpy(images_u8).to(device)
    cls = torch.from_numpy(cls_label).to(device)
    text = text_attr.to(device)
    times = []
    for _ in range(2):
        _synchronize(device)
        t0 = time.perf_counter()
        labels = training_free_step(clip_params, images, cls, text, cfg)
        _synchronize(device)
        times.append(time.perf_counter() - t0)
    return labels.cpu().numpy(), times[0], times[1]


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--params", default=None,
                    help="converted CLIP params .npz (default: random init)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=None,
                    help="default 320, or a named --backbone's size")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model config (CI / smoke)")
    add_backbone_arg(ap)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    exact_matmuls()
    cfg = with_backbone(tiny_config() if args.tiny else voc_config(),
                        args.backbone, tiny=args.tiny)
    if args.image_size is None:
        args.image_size = (320 if args.backbone == DEFAULT_BACKBONE
                           else cfg.clip.image_size)
    if args.image_size != cfg.clip.image_size:
        cfg = dataclasses.replace(
            cfg, clip=dataclasses.replace(cfg.clip,
                                          image_size=args.image_size))
    if args.params:
        clip_params = load_params_npz(args.params, cfg.clip, device)
    else:
        clip_params = init_clip_params(cfg.clip,
                                       torch.Generator().manual_seed(0),
                                       device)

    size = cfg.clip.image_size
    images, cls_label = synthetic_batch(args.batch, size, cfg.num_fg)
    text_attr = random_text_bank(cfg.num_fg + 25, cfg.clip.embed_dim)

    print(device_line(device))
    labels, t_first, t_run = run_demo(clip_params, images, cls_label,
                                      text_attr, cfg, device)
    vals, counts = np.unique(labels, return_counts=True)
    print(f"first call (build + run): {t_first:.2f}s   steady-state: "
          f"{t_run * 1e3:.1f}ms ({args.batch / t_run:.1f} img/s)")
    print(f"pseudo-label shape: {labels.shape}  dtype: {labels.dtype}")
    print("label histogram:",
          {int(v): int(c) for v, c in zip(vals, counts)})
    if labels.shape != (args.batch, size, size):
        raise AssertionError(f"labels of shape {labels.shape}")
    if not set(vals.tolist()) <= set(range(cfg.num_classes)) | {255}:
        raise AssertionError(f"labels outside the classes: {vals}")
    print("OK")
    return labels


if __name__ == "__main__":
    main()
