"""ExCEL composition and the text bank (counterpart of
excel_tpu/models/excel.py).

params = {"clip": <frozen encoder tree>, "head": <LvcHead>}. Only the head
trains: the encoder runs under `torch.no_grad()`, so autograd records the
head's forward alone.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import ExcelConfig
from ..ops.surgery import clip_feature_surgery
from ..ops.tse import attr_aggregate
from .clip import encode_image, encode_text_ensemble
from .head import (LvcHead, decoder_forward, feature_affinity,
                   init_head_params, segformer_fuse)


@dataclasses.dataclass(frozen=True)
class ExcelOutputs:
    segs: torch.Tensor          # [B, hw, num_classes] decoder logits
    fused: torch.Tensor         # [B, hw, embed] LVC features (detached)
    lams: torch.Tensor          # [B, hw, num_fg] raw LAMs (patch tokens)
    attn_weights: torch.Tensor | None  # encoder attention, per attn_mode
    attn_pred: torch.Tensor     # [B, hw, hw] sigmoid feature affinity
    seg_attn: torch.Tensor      # [layers, B, hw, hw] decoder attention


def compute_lams(image_out: dict, text_attr: torch.Tensor,
                 num_fg: int) -> torch.Tensor:
    """Feature surgery -> fg LAMs [B, hw, num_fg] (drop the CLS row and the
    background-class columns)."""
    maps = clip_feature_surgery(image_out["projected"], text_attr)
    return maps[:, 1:, :num_fg]


def excel_forward(params: dict, images: torch.Tensor,
                  text_attr: torch.Tensor, cfg: ExcelConfig, *,
                  ex_feats: torch.Tensor | None = None,
                  dropout_generator: torch.Generator | None = None,
                  attn_mode: str = "stack"):
    """Full forward. images: [B, H, W, 3] normalised NHWC.

    ex_feats: optional [B, hw, embed] LVC features; when given, runs the
    LAM-only calibrated encoder pass (attention outputs skipped) and
    returns just the LAMs. dropout_generator: the head's Dropout2d draws
    (training); None runs without dropout. attn_mode: the encoder's
    attention output, as in models/clip.vision_forward.

    `fused` is returned detached, but `attn_pred` is computed from the live
    one: the diversity loss trains the head through it; `segs` and
    `seg_attn` keep their gradient too."""
    grid = images.shape[1] // cfg.clip.patch_size
    if ex_feats is not None:
        b, n, c = ex_feats.shape
        ex_nchw = ex_feats.transpose(1, 2).reshape(b, c, grid, grid)
        with torch.no_grad():
            out = encode_image(params["clip"], images, cfg.clip,
                               ex_feats=ex_nchw, attn_mode="none")
            return compute_lams(out, text_attr, cfg.num_fg)

    with torch.no_grad():
        out = encode_image(params["clip"], images, cfg.clip,
                           attn_mode=attn_mode)
        lams = compute_lams(out, text_attr, cfg.num_fg)
    head: LvcHead = params["head"]
    fused = segformer_fuse(head, out["feats"][:, :, 1:, :],
                           dropout_generator, cfg.head.dropout)
    segs, seg_attn = decoder_forward(head, fused)
    return ExcelOutputs(segs=segs, fused=fused.detach(), lams=lams,
                        attn_weights=out["attn"],
                        attn_pred=feature_affinity(fused), seg_attn=seg_attn)


def init_excel_params(cfg: ExcelConfig, clip_params: dict,
                      generator: torch.Generator | None = None,
                      device="cuda") -> dict:
    return {"clip": clip_params,
            "head": init_head_params(cfg.head, cfg.num_classes, generator,
                                     device)}


def build_text_bank(clip_params: dict, cfg: ExcelConfig,
                    vocabulary: list[str],
                    cluster_bank: torch.Tensor) -> torch.Tensor:
    """Enriched text embeddings [num_fg + num_bg, embed] float32 on the
    device of the text weights: `cfg.prompt_template` over `vocabulary`
    (text.class_names.prompt_vocabulary: fg names then bg names), tokenized
    at the context length 77, one template per class through
    `encode_text_ensemble`, then TSE (`attr_aggregate`) over
    `cluster_bank` [embed, K]."""
    from ..text.tokenizer import tokenize

    prompts = [cfg.prompt_template.format(n) for n in vocabulary]
    device = clip_params["text"]["token_embedding"].device
    tokens = torch.from_numpy(tokenize(prompts)).to(device)[:, None, :]
    with torch.no_grad():
        emb = encode_text_ensemble(clip_params, tokens, cfg.clip)
        return attr_aggregate(emb, cluster_bank.to(device), cfg.num_fg)
