"""Input normalisation, the encoder's attention mode, and the crop-resolution
pseudo-label pipelines of training and LAM inference (counterpart of
excel_tpu/engine/pipeline.py)."""
from __future__ import annotations

import functools

import torch

from ..config import ExcelConfig
from ..models.clip import encode_image
from ..models.excel import compute_lams, excel_forward
from ..ops.affinity import refine_lams_batch
from ..ops.labels import (argmax_label, cams_with_background,
                          class_slot_index, slot_label_to_class)
from ..ops.par import par_refine
from ..utils import profiling

# ImageNet stats in 0-255 space
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


@functools.lru_cache(maxsize=None)
def _stats_on(device: torch.device):
    """(mean, 1 / std) in float32 and (mean, std) in float64 on `device`,
    made once."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32)
    return tuple(v.to(device) for v in (mean, 1.0 / std, mean.double(),
                                        std.double()))


def normalize_images(images_u8: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] uint8/float 0-255 -> normalised float32 NHWC, as the
    JAX package's compiled programs compute it: XLA turns the division by
    the constant std into a product with its float32 reciprocal."""
    x = images_u8.float()
    mean, inv_std, _, _ = _stats_on(x.device)
    return (x - mean) * inv_std


def denormalize_images(images: torch.Tensor) -> torch.Tensor:
    """Normalised NHWC -> [0, 1] float32 with the reference's uint8
    truncation, floor(x * std + mean) / 255: the PAR guidance of training.

    An ulp in x * std + mean moves a whole grey level, so this follows the
    arithmetic of the JAX package's compiled train step bit for bit (XLA's
    fusion on the CPU): x * std + mean as one fused multiply-add, rounded
    once to float32, and the division by 255 as a product with its float32
    reciprocal. The fused multiply-add is formed in float64, where the
    product of two float32 values is exact, in two separate kernels, so
    that no compiler contracts them on either device; over the 256 x 3
    normalised byte values, the only inputs of training, this rounds as
    the fused operation does (tests/test_torch_pipeline.py)."""
    _, _, mean64, std64 = _stats_on(images.device)
    x = images.double() * std64
    x = (x + mean64).float()
    return torch.clamp(torch.floor(x), 0, 255) * (1.0 / 255.0)


def attn_mode_for(cfg: ExcelConfig) -> str:
    """Encoder attention mode for the no-seg_attn SVC path: "mean" (block
    mean accumulated in the kernels) when the encoder's attention window
    equals the SVC consumption length, else the always-correct "stack"."""
    return ("mean" if cfg.clip.attn_out_layers == cfg.refine.attn_layers
            else "stack")


def lam_forward(clip_params: dict, images: torch.Tensor,
                text_attr: torch.Tensor, cfg: ExcelConfig,
                attn_mode: str | None = None):
    """Training-free forward, frozen encoder only: (lams [B, hw, num_fg],
    attention per `attn_mode`, by default `attn_mode_for(cfg)`)."""
    out = encode_image(clip_params, images, cfg.clip,
                       attn_mode=attn_mode or attn_mode_for(cfg))
    return compute_lams(out, text_attr, cfg.num_fg), out["attn"]


@torch.no_grad()
def pseudo_labels(lams: torch.Tensor, attn_weights: torch.Tensor,
                  par_images: torch.Tensor, cls_label: torch.Tensor,
                  cfg: ExcelConfig, out_hw: tuple[int, int],
                  caa_threshold: float,
                  seg_attn: torch.Tensor | None = None,
                  class_slots: int | None = None) -> torch.Tensor:
    """LAMs -> SVC -> + background at crop resolution -> PAR (full extent)
    -> argmax pseudo-labels [B, H, W] int32.

    lams [B, hw, num_fg]; par_images [B, 3, H, W] guidance at out_hw;
    class_slots: refine bg + this many present-class channels only (exact
    when every image has at most that many present classes)."""
    with profiling.span("labels"):
        b, hw, c = lams.shape
        grid = int(round(hw ** 0.5))
        lams = lams.transpose(1, 2)                           # [B, C, hw]
        if class_slots is not None and class_slots < c:
            idx, cls_sel = class_slot_index(cls_label, class_slots)
            lams = torch.gather(lams, 1, idx[:, :, None].expand(-1, -1, hw))
        else:
            idx, cls_sel = None, cls_label
        refined = refine_lams_batch(
            lams, attn_weights, caa_threshold, (grid, grid),
            attn_layers=cfg.refine.attn_layers, seg_attn=seg_attn)
        cams = cams_with_background(refined.reshape(b, -1, grid, grid),
                                    cls_sel, out_hw)
        cams = par_refine(
            par_images, cams, dilations=tuple(cfg.refine.par_dilations),
            num_iter=cfg.refine.par_iters,
            dtype=torch.bfloat16 if cfg.refine.par_bf16 else None)
        label = argmax_label(cams, cls_sel,
                             ignore_index=cfg.refine.ignore_index)
        return label if idx is None else slot_label_to_class(label, idx)


@torch.inference_mode()
def training_free_step(clip_params: dict, images_u8: torch.Tensor,
                       cls_label: torch.Tensor, text_attr: torch.Tensor,
                       cfg: ExcelConfig,
                       class_slots: int | None = None) -> torch.Tensor:
    """Batched training-free pseudo-labels at crop resolution: images_u8
    [B, H, W, 3] -> labels [B, H, W] (no seg_attn, normalised images guide
    PAR)."""
    images = normalize_images(images_u8)
    lams, attn = lam_forward(clip_params, images, text_attr, cfg)
    return pseudo_labels(lams, attn, images.permute(0, 3, 1, 2), cls_label,
                         cfg, tuple(images.shape[1:3]),
                         cfg.refine.caa_threshold, class_slots=class_slots)


@torch.inference_mode()
def trained_lam_step(params: dict, images_u8: torch.Tensor,
                     cls_label: torch.Tensor, text_attr: torch.Tensor,
                     cfg: ExcelConfig, calibrated: bool = True,
                     class_slots: int | None = None):
    """Trained-mode LAM inference: the full model, the LVC-calibrated second
    encoder pass, attn_pred as seg_attn. Returns (labels [B, H, W], seg
    logits [B, hw, C])."""
    images = normalize_images(images_u8)
    out = excel_forward(params, images, text_attr, cfg)
    lams = out.lams
    if calibrated:
        lams = excel_forward(params, images, text_attr, cfg,
                             ex_feats=out.fused)
    labels = pseudo_labels(lams, out.attn_weights,
                           images.permute(0, 3, 1, 2), cls_label, cfg,
                           tuple(images.shape[1:3]), cfg.refine.caa_threshold,
                           seg_attn=out.attn_pred, class_slots=class_slots)
    return labels, out.segs
