"""Typed configuration tree: the port's copy of excel_tpu/config.py.

The same dataclasses, defaults and presets, with torch dtypes in place of
jax.numpy ones (the JAX module imports jax.numpy, so the port keeps its own
copy). The JAX package's `fused_attention` switch has no counterpart: the
encoder always calls the attention kernels' wrappers, which launch the CUDA
kernels on CUDA tensors and take their plain versions on CPU tensors.
`fast()` gives the production preset: a bf16 encoder, bf16 PAR storage and
bf16 messages in the on-device CRF.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import torch


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def asset_path(*parts: str) -> str:
    return os.path.join(_repo_root(), "assets", *parts)


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    """ViT-B/16 CLIP with ExCEL architecture surgery."""
    image_size: int = 320
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    embed_dim: int = 512
    # pretrained positional table side (224/16); interpolated to image_size/16
    pretrain_grid: int = 14
    # architecture surgery: the reference requests 6 blocks but its loop
    # replaces only the last 5 (clip_surgery_model.py:399 `range(1, 6)`);
    # we replicate the effective behavior.
    surgery_blocks: int = 5
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    # compute dtype for the big matmuls; LayerNorm/softmax always run fp32
    compute_dtype: torch.dtype = torch.float32
    # how many trailing blocks' attention weights the encoder returns
    # (None = all). SVC only ever consumes the last `refine.attn_layers`.
    # Presets set 6; None keeps the full stack (parity tests).
    attn_out_layers: int | None = None

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def tokens(self) -> int:
        return self.grid * self.grid + 1


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """LVC trainable head (SegFormer-style fuse + transformer decoder)."""
    embedding_dim: int = 256
    in_channels: int = 768           # ViT block width feeding the fuse MLPs
    num_blocks: int = 12             # one MLP per ViT block
    decoder_layers: int = 3
    decoder_heads: int = 8
    dropout: float = 0.1


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """SVC + PAR pseudo-label refinement."""
    caa_threshold: float = 0.79      # train_voc.py:196 (0.88 COCO, 0.75 val)
    val_caa_threshold: float = 0.75  # validatation_engine.py:33
    attn_layers: int = 6             # refine_cams_with_aff default
    par_dilations: Sequence[int] = (1, 2, 4, 8, 12, 24)
    par_iters: int = 20              # train_voc.py:112
    par_w1: float = 0.3
    par_w2: float = 0.01
    bkg_thre: float = 0.5
    high_thre: float = 0.7
    low_thre: float = 0.25
    radius: int = 8                  # affinity-label radius mask
    ignore_index: int = 255
    max_classes_per_image: int = 8   # static padding for vmapped per-class SVC
    # eval-sweep class-slot buckets: PAR's cost grows with its channel
    # count (bg + slots), so batches are grouped by each image's bucket
    # (engine/evaluate._bucketed_batches); 12/16 keep COCO's rare
    # many-class images off the 81-channel full stack.
    slot_buckets: Sequence[int] = (2, 3, 4, 5, 6, 8, 12, 16)
    # bf16 storage/multiplies in PAR diffusion (fp32 affinity + accumulate);
    # fp32 default matches the reference bit-for-bit
    par_bf16: bool = False


@dataclasses.dataclass(frozen=True)
class CrfConfig:
    """Dense-CRF post-processing: the parameters of the reference's dense
    CRF, and the switches of the on-device convolutional mean-field
    (ops/crf_tpu.py)."""
    iters: int = 10
    pos_w: float = 3.0
    pos_xy_std: float = 1.0
    bi_w: float = 4.0
    bi_xy_std: float = 67.0
    bi_rgb_std: float = 3.0
    # bf16 message passing for the conv mean-field
    msg_bf16: bool = False
    # coarse long-range bilateral level for the conv mean-field
    long_range: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    max_iters: int = 30000
    warmup_iters: int = 50
    log_iters: int = 200
    eval_iters: int = 2000
    batch_size: int = 4              # per replica ("spg" in the reference)
    lr: float = 1e-4
    warmup_ratio: float = 1e-6
    weight_decay: float = 1e-2
    betas: tuple[float, float] = (0.9, 0.999)
    power: float = 1.0
    w_seg: float = 1.0
    w_diver: float = 0.1
    # schedule thresholds (train_voc.py:188,210 / train_coco.py)
    lvc_calibrate_iter: int = 14000  # switch LAM source to LVC-calibrated attn
    seg_affinity_iter: int = 24000   # switch affinity labels to seg argmax
    # "poly" (PolyWarmupAdamW, the shipped default), "cos" (CosWarmupAdamW),
    # "poly_sgd" (PolyWarmupSGD + momentum 0.9)
    schedule: str = "poly"
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "pascal_voc"
    root_dir: str = "/data/VOC2012"
    split_dir: str = ""
    train_split: str = "train_aug"
    val_split: str = "val"
    crop_size: int = 320
    rescale_range: tuple[float, float] = (0.5, 2.0)
    num_classes: int = 21
    ignore_index: int = 255
    # padded eval canvas (valid-region masking gives exact per-size behavior)
    eval_pad: int = 512

    def __post_init__(self):
        if not self.split_dir:
            ds = "voc" if "voc" in self.dataset else "coco"
            object.__setattr__(self, "split_dir", asset_path("splits", ds))


@dataclasses.dataclass(frozen=True)
class ExcelConfig:
    clip: ClipConfig = dataclasses.field(default_factory=ClipConfig)
    head: HeadConfig = dataclasses.field(default_factory=HeadConfig)
    refine: RefineConfig = dataclasses.field(default_factory=RefineConfig)
    crf: CrfConfig = dataclasses.field(default_factory=CrfConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    num_classes: int = 21            # incl. background
    num_attr_clusters: int = 112
    prompt_template: str = "a clean origami {}."

    @property
    def num_fg(self) -> int:
        return self.num_classes - 1


def voc_config(**overrides) -> ExcelConfig:
    cfg = ExcelConfig(clip=ClipConfig(attn_out_layers=6))
    return dataclasses.replace(cfg, **overrides)


def tiny_config(**overrides) -> ExcelConfig:
    """Miniature model for tests and multi-chip dryruns: same code paths
    (surgery blocks, pos-emb interpolation, SVC/PAR refinement, LVC head),
    ~1000x less compute. Not a reference configuration."""
    cfg = ExcelConfig(
        clip=ClipConfig(image_size=64, vision_width=64, vision_layers=4,
                        vision_heads=2, embed_dim=32, pretrain_grid=2,
                        surgery_blocks=2, context_length=16, vocab_size=512,
                        text_width=32, text_heads=2, text_layers=2,
                        attn_out_layers=2),
        head=HeadConfig(embedding_dim=32, in_channels=64, num_blocks=4,
                        decoder_layers=2, decoder_heads=2),
        refine=RefineConfig(attn_layers=2, par_dilations=(1, 2), par_iters=2,
                            radius=2, max_classes_per_image=4),
        train=TrainConfig(max_iters=10, warmup_iters=2, eval_iters=5,
                          batch_size=8, lvc_calibrate_iter=4,
                          seg_affinity_iter=8),
        data=DataConfig(crop_size=64, num_classes=6),
        num_classes=6,
        num_attr_clusters=12,
    )
    return dataclasses.replace(cfg, **overrides)


def fast(cfg: ExcelConfig) -> ExcelConfig:
    """Production fast path: bf16 encoder matmuls (fp32 LayerNorm/softmax)
    + bf16 PAR diffusion. LAM correlation vs fp32 > 0.9999 (tests)."""
    return dataclasses.replace(
        cfg,
        clip=dataclasses.replace(cfg.clip, compute_dtype=torch.bfloat16),
        refine=dataclasses.replace(cfg.refine, par_bf16=True),
        crf=dataclasses.replace(cfg.crf, msg_bf16=True))


def coco_config(**overrides) -> ExcelConfig:
    cfg = ExcelConfig(
        clip=ClipConfig(attn_out_layers=6),
        refine=RefineConfig(caa_threshold=0.88),
        train=TrainConfig(
            max_iters=100000,
            warmup_iters=200,
            eval_iters=10000,
            lvc_calibrate_iter=30000,
            seg_affinity_iter=1 << 30,  # COCO never switches to seg affinity
        ),
        data=DataConfig(dataset="ms_coco", root_dir="/data/coco2014",
                        num_classes=81, eval_pad=640),
        num_classes=81,
        num_attr_clusters=224,
    )
    return dataclasses.replace(cfg, **overrides)
