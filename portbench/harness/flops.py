"""Operations and bytes that the measured layers need, counted from their
input and output shapes, never from what one implementation does.

Matrix products count 2 FLOPs a multiply-add. A layer's bytes read each
input once and write each output once; no intermediate of today's kernels
counts. These counts are the yardstick of the `mfu` and `_roofline`
metrics: a change that fuses or splits kernels is held to the same count.
"""
from __future__ import annotations

import math


def _elem(dtype_name: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2, "float8": 1}[dtype_name]


def encoder_flops(ccfg, size: int, calibrated: bool = False) -> float:
    """Matrix products of one image through the surgery ViT at size x size
    (the patch embedding, every block's projections, attention products
    and MLP; the dense path's shared-weights product; the final
    projection). calibrated adds nothing here: the calibration is an
    addition to the mix."""
    g = size // ccfg.patch_size
    n = g * g + 1
    c = ccfg.vision_width
    single = ccfg.vision_layers - ccfg.surgery_blocks
    patch = 2.0 * (n - 1) * c * 3 * ccfg.patch_size ** 2
    plain = 24.0 * n * c * c + 4.0 * n * n * c
    surgery = 26.0 * n * c * c + 12.0 * n * n * c
    return (patch + single * plain + ccfg.surgery_blocks * surgery
            + 2.0 * n * c * ccfg.embed_dim)


def surgery_lam_flops(ccfg, size: int, text_rows: int) -> float:
    """Feature surgery of one image: the token-class and CLS products."""
    g = size // ccfg.patch_size
    n = g * g + 1
    return 2.0 * n * ccfg.embed_dim * text_rows + 2.0 * n * ccfg.embed_dim \
        + 4.0 * ccfg.embed_dim * text_rows


def svc_flops(hw: int, channels: int) -> float:
    """SVC of one image: the transition matrix squared, then applied to the
    masked maps."""
    return 2.0 * hw ** 3 + 2.0 * hw * hw * channels


def head_flops(hcfg, tokens: int, num_classes: int) -> float:
    """The LVC head's forward on one image's tokens: fuse MLPs, channel
    fuse, decoder blocks, classifier."""
    d, c, m = hcfg.embedding_dim, hcfg.in_channels, tokens
    fuse = hcfg.num_blocks * (2.0 * m * c * d + 2.0 * m * d * d)
    fuse += 2.0 * m * hcfg.num_blocks * d * d
    dec = hcfg.decoder_layers * (24.0 * m * d * d + 4.0 * m * m * d)
    return fuse + dec + 2.0 * m * d * num_classes


def attention_layer(kind: str, b: int, n: int, c: int, dtype: str,
                    weights_out: bool, ex: bool) -> tuple[float, float]:
    """(FLOPs, bytes) of one call of the encoder's attention layer
    (models/layers.attention_fused or surgery_attention_fused): the qkv
    projection, the attention products, the output projection(s). Bytes:
    the normed input, the layer's weights, the output(s), the fp32 weights
    accumulator read and written where the call returns weights, and the
    calibration where given."""
    e = _elem(dtype)
    if kind == "plain":
        flops = b * (8.0 * n * c * c + 4.0 * n * n * c)
        outs = 1
    else:
        flops = b * (10.0 * n * c * c + 12.0 * n * n * c)
        outs = 2
    nbytes = (b * n * c * e + (4 * c * c + 4 * c) * e + outs * b * n * c * e)
    if weights_out:
        nbytes += 2 * b * n * n * 4
    if ex:
        nbytes += b * (n - 1) ** 2 * e
    return flops, nbytes


def par_layer(b: int, c: int, h: int, w: int, k: int,
              iters: int) -> tuple[float, float]:
    """(FLOPs, bytes) of ops/par.par_refine as a whole: the fp32 image
    [B, 3, H, W] and masks [B, C, H, W] read once, the refined masks
    written once; the affinity (per pixel and offset: the moments over 3
    channels, 3 x 3; the logit, 3 x 5 + 1; the softmax, 4; the position
    term, 1; per pixel the 3 standard deviations, 3 x 6) and `iters`
    diffusion steps of K multiply-adds a channel."""
    px = b * h * w
    flops = px * (k * 30.0 + 18.0 + iters * k * c * 2.0)
    return flops, 4.0 * px * (3 + 2 * c)


def mfu_percent(flops: float, seconds: float, peak: float) -> float:
    return 100.0 * flops / (seconds * peak) if seconds > 0 else math.nan
