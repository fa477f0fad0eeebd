"""Input normalisation and the encoder's attention mode (counterpart of
excel_tpu/engine/pipeline.py, the parts the LAM eval path uses)."""
from __future__ import annotations

import torch

from ..config import ExcelConfig

# ImageNet stats in 0-255 space
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def normalize_images(images_u8: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] uint8/float 0-255 -> normalised float32 NHWC."""
    x = images_u8.float()
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def attn_mode_for(cfg: ExcelConfig) -> str:
    """Encoder attention mode for the no-seg_attn SVC path: "mean" (block
    mean accumulated in the kernels) when the encoder's attention window
    equals the SVC consumption length, else the always-correct "stack"."""
    return ("mean" if cfg.clip.attn_out_layers == cfg.refine.attn_layers
            else "stack")
