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


# an image's per-channel (mean, std) in 0-255 space: ImageNet's (CLIP's,
# OpenCLIP's and EVA-CLIP's towers), SigLIP's 0.5 / 0.5 of the 0-1 range
IMAGENET_STATS = ((123.675, 116.28, 103.53), (58.395, 57.12, 57.375))
SIGLIP_STATS = ((127.5, 127.5, 127.5), (127.5, 127.5, 127.5))


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    """A CLIP ViT with ExCEL architecture surgery; the defaults are OpenAI's
    ViT-B/16 (`BACKBONES` names the others)."""
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
    # the MLP activation of both towers' blocks: "quick_gelu" (OpenAI's
    # x * sigmoid(1.702 x)), "gelu" (exact, erf; OpenCLIP's nn.GELU; an
    # EVA-02 tower's text blocks alone) or "gelu_tanh" (SigLIP's
    # gelu_pytorch_tanh)
    activation: str = "quick_gelu"
    # the vision tower's parameter layout that init_clip_params draws:
    # "vit" (OpenAI's and OpenCLIP's) or "eva02" (no ln_pre, a patch and a
    # head bias, each block's sub-LayerNorm `attn.ln_inner` and SwiGLU
    # `mlp.fc` = W1|W2, `mlp.ln_ffn`, `mlp.proj` = W3; models/params) or
    # "siglip" (no ln_pre, no class embedding, a patch bias, the
    # attention-pooling head `map_head`, no proj). The forward takes each
    # of these parts where the tree holds it.
    block: str = "vit"
    # the vision MLP's hidden width; 0: 4 x vision_width
    mlp_hidden: int = 0
    # 2D rotary q/k at the patch tokens (EVA-02): the grid that positions
    # are scaled to (its pt_hw_seq_len, 16); 0: no rotation
    rope_grid: int = 0
    # the vision tower's LayerNorm eps (EVA-02: 1e-6)
    ln_eps: float = 1e-5
    # the input's per-channel mean and std in 0-255 space (`image_stats`)
    image_mean: tuple = IMAGENET_STATS[0]
    image_std: tuple = IMAGENET_STATS[1]
    # the text tower: a causal mask (CLIP's) or none (SigLIP's); the
    # pooled token "eot" (the argmax id, CLIP's) or "last" (SigLIP's);
    # its LayerNorm eps and MLP hidden width (0: 4 x text_width)
    text_causal: bool = True
    text_pool: str = "eot"
    text_ln_eps: float = 1e-5
    text_mlp_hidden: int = 0

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def image_stats(self) -> tuple:
        """(mean, std) of the input's channels in 0-255 space."""
        return (tuple(self.image_mean), tuple(self.image_std))

    @property
    def patch_start(self) -> int:
        """The first patch row of the token layout: 1 after the class
        token, 0 in a SigLIP tower, which has none (its tree holds no
        `class_embedding`)."""
        return 0 if self.block == "siglip" else 1

    @property
    def tokenizer(self) -> str:
        """The text tower's tokenizer: "clip" (the bundled BPE) or, for a
        SigLIP tower, "siglip" (SentencePiece, whose model file the
        repository does not hold)."""
        return "siglip" if self.block == "siglip" else "clip"

    @property
    def tokens(self) -> int:
        return self.grid * self.grid + self.patch_start

    @property
    def hidden(self) -> int:
        """The vision MLP's hidden width."""
        return self.mlp_hidden or 4 * self.vision_width


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


# CLIP towers the port runs, by name: each entry's "full" fields are its
# published shape (ClipConfig fields; the ExCEL head follows the vision
# width and depth), its "tiny" fields what `tiny_config` changes for the
# CPU tests and `--tiny` runs (the head dim, activation and patch kept).
# The head width and the activation are not in a checkpoint's shapes, so a
# backbone is named, never inferred.
BACKBONES = {
    # OpenAI CLIP ViT-B/16 (github.com/openai/CLIP): the ClipConfig
    # defaults and tiny_config's widths as they are
    "openai-vit-b-16": {"full": {}, "tiny": {}},
    # OpenCLIP ViT-H/14 (github.com/mlfoundations/open_clip,
    # src/open_clip/model_configs/ViT-H-14.json, laion2b_s32b_b79k):
    # 32 blocks of width 1280, head_width 80 (16 heads), MLP 5120, patch
    # 14, pretraining grid 16; text 24 x 1024, 16 heads; embed 1024;
    # quick_gelu false. 336 px: ExCEL's 320 is not a multiple of 14 (24
    # patches, as CLIP's L/14@336).
    "openclip-vit-h-14": {
        "full": dict(image_size=336, patch_size=14, vision_width=1280,
                     vision_layers=32, vision_heads=16, embed_dim=1024,
                     pretrain_grid=16, text_width=1024, text_heads=16,
                     text_layers=24, activation="gelu"),
        "tiny": dict(image_size=56, patch_size=14, vision_width=160,
                     vision_heads=2, activation="gelu"),
    },
    # EVA02-CLIP-L/14-336 (github.com/baaivision/EVA, EVA-CLIP/rei/
    # eva_clip/model_configs/EVA02-CLIP-L-14-336.json,
    # EVA02_CLIP_L_336_psz14_s6B): 24 blocks of width 1024, head_width 64
    # (16 heads), SwiGLU at int(1024 x 2.6667) = 2730 with its sub-LN
    # (naiveswiglu, subln), the sub-LN on the attention context, 2D rotary
    # q/k from pt_hw_seq_len 16 (intp_freq), LayerNorm eps 1e-6, no
    # ln_pre; patch 14 at 336 px, a positional table of the 24 x 24 grid;
    # embed 768; text 12 x 768, 12 heads, nn.GELU (quick_gelu unset). The
    # patch embedding's and the head's biases are parameters
    # (models/params).
    "eva02-clip-l-14-336": {
        "full": dict(image_size=336, patch_size=14, vision_width=1024,
                     vision_layers=24, vision_heads=16, embed_dim=768,
                     pretrain_grid=24, text_width=768, text_heads=12,
                     text_layers=12, activation="gelu", block="eva02",
                     mlp_hidden=2730, rope_grid=16, ln_eps=1e-6),
        # width 128 in 2 heads of 64: int(128 x 2.6667) = 341, no multiple
        # of 8, as 2730 is none
        "tiny": dict(image_size=56, patch_size=14, vision_width=128,
                     vision_heads=2, pretrain_grid=4, activation="gelu",
                     block="eva02", mlp_hidden=341, rope_grid=16,
                     ln_eps=1e-6),
    },
    # SigLIP So400m/14-384 (arXiv 2303.15343, 2305.13035; huggingface.co/
    # google/siglip-so400m-patch14-384 config.json with transformers'
    # Siglip*Config defaults): 27 blocks of width 1152, 16 heads of 72,
    # MLP 4304 with gelu_pytorch_tanh, LayerNorm eps 1e-6, patch 14 with
    # bias, no class token and a 27 x 27 positional table, post_layernorm
    # and the attention-pooling head (probe, 16-head MHA, LayerNorm, MLP
    # 4304), no projection: the embedding is 1152 wide; mean and std 0.5;
    # text 27 x 1152, 16 heads, MLP 4304, vocab 32,000, 64 positions, no
    # mask, pooled at the last position through a head with bias. 378 px:
    # 27 x 14, the 729 tokens the published 384 px conv reads.
    "siglip-so400m-14-384": {
        "full": dict(image_size=378, patch_size=14, vision_width=1152,
                     vision_layers=27, vision_heads=16, embed_dim=1152,
                     pretrain_grid=27, context_length=64, vocab_size=32000,
                     text_width=1152, text_heads=16, text_layers=27,
                     activation="gelu_tanh", block="siglip",
                     mlp_hidden=4304, ln_eps=1e-6, image_mean=SIGLIP_STATS[0],
                     image_std=SIGLIP_STATS[1],
                     text_causal=False, text_pool="last", text_ln_eps=1e-6,
                     text_mlp_hidden=4304),
        # width 144 in 2 heads of 72; a hidden of 536, a multiple of 8
        # that is not 4 x 144 (4304 is not 4 x 1152)
        "tiny": dict(image_size=56, patch_size=14, vision_width=144,
                     vision_heads=2, embed_dim=144, pretrain_grid=4,
                     activation="gelu_tanh", block="siglip",
                     mlp_hidden=536, ln_eps=1e-6, image_mean=SIGLIP_STATS[0],
                     image_std=SIGLIP_STATS[1],
                     text_causal=False, text_pool="last", text_ln_eps=1e-6,
                     text_mlp_hidden=88),
    },
}
DEFAULT_BACKBONE = "openai-vit-b-16"


def with_backbone(cfg: ExcelConfig, name: str,
                  tiny: bool = False) -> ExcelConfig:
    """cfg with the named CLIP tower (`BACKBONES`): its encoder fields, the
    head's in_channels / num_blocks set to the vision width and depth, and
    a training crop of the tower's image size where the patch does not
    divide the preset's."""
    if name not in BACKBONES:
        raise ValueError(f"unknown backbone {name!r}; known: "
                         f"{', '.join(BACKBONES)}")
    fields = BACKBONES[name]["tiny" if tiny else "full"]
    if not fields:
        return cfg
    clip = dataclasses.replace(cfg.clip, **fields)
    head = dataclasses.replace(cfg.head, in_channels=clip.vision_width,
                               num_blocks=clip.vision_layers)
    data = cfg.data
    if data.crop_size % clip.patch_size:
        data = dataclasses.replace(data, crop_size=clip.image_size)
    return dataclasses.replace(cfg, clip=clip, head=head, data=data)


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
