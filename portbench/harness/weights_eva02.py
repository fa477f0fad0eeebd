"""EVA-02's vision tower drawn on the device from the seed, as
harness/weights.py draws OpenAI's: one large draw, the program's torch
layout (linear weights [out, in], the patch embedding [width, 3, P, P]),
the JAX package's init scales, biases and LayerNorm affine parameters drawn
small around 0 and 1, linear weights and biases in the compute type.

EVA-02's leaves beside a ViT's (models/params.py): `patch_bias`, the
sub-LayerNorm `attn.ln_inner`, the SwiGLU's W1 and W2 stacked in
`mlp.fc` [2 h, width] with `mlp.ln_ffn` [h] and W3 in `mlp.proj`
[width, h], the head's `proj_bias`; no `ln_pre`; the qkv bias drawn for q
and v and zero for k (EVA-02's k projection has none). h is the
configuration's published hidden width (2,730): the program's loaders pad
a copy of it for serving (models/params.pad_swiglu)."""
from __future__ import annotations

import torch

from .weights import AFFINE_STD, _gen, _numel, _set


def _specs_block(width, hidden, std_qkv, std_proj, std_fc):
    return [("ln_1.scale", (width,), "ln"), ("ln_1.bias", (width,), "bias"),
            ("attn.qkv.w", (3 * width, width), std_qkv),
            ("attn.qkv.b", (3 * width,), "qkv_bias"),
            ("attn.ln_inner.scale", (width,), "ln"),
            ("attn.ln_inner.bias", (width,), "bias"),
            ("attn.out.w", (width, width), std_proj),
            ("attn.out.b", (width,), "bias"),
            ("ln_2.scale", (width,), "ln"), ("ln_2.bias", (width,), "bias"),
            ("mlp.fc.w", (2 * hidden, width), std_fc),
            ("mlp.fc.b", (2 * hidden,), "bias"),
            ("mlp.ln_ffn.scale", (hidden,), "ln"),
            ("mlp.ln_ffn.bias", (hidden,), "bias"),
            ("mlp.proj.w", (width, hidden), std_proj),
            ("mlp.proj.b", (width,), "bias")]


def clip_visual(ccfg, seed: int, device) -> dict:
    """{"visual": tree} of the program's EVA-02 encoder."""
    w, layers = ccfg.vision_width, ccfg.vision_layers
    std = w ** -0.5
    proj_std = std * (2 * layers) ** -0.5
    specs = [("patch_embed", (w, 3, ccfg.patch_size, ccfg.patch_size), std),
             ("patch_bias", (w,), "bias"),
             ("class_embedding", (w,), std),
             ("positional_embedding", (ccfg.pretrain_grid ** 2 + 1, w), std)]
    for i in range(layers):
        specs += [(f"blocks.{i}.{n}", s, d)
                  for n, s, d in _specs_block(w, ccfg.hidden, std, proj_std,
                                              (2 * w) ** -0.5)]
    specs += [("ln_post.scale", (w,), "ln"), ("ln_post.bias", (w,), "bias"),
              ("proj", (w, ccfg.embed_dim), std),
              ("proj_bias", (ccfg.embed_dim,), "bias")]
    total = sum(_numel(s) for _, s, _ in specs)
    flat = torch.randn(total, generator=_gen(seed, "clip", device),
                       device=device)
    served = ccfg.compute_dtype
    tree: dict = {}
    pos = 0
    for name, shape, kind in specs:
        n = _numel(shape)
        x = flat[pos:pos + n].reshape(shape)
        pos += n
        if kind == "ln":
            x = 1.0 + AFFINE_STD * x
        elif kind in ("bias", "qkv_bias"):
            x = AFFINE_STD * x
            if kind == "qkv_bias":
                x[w:2 * w] = 0.0
        else:
            x = x * kind
        if name.endswith((".w", ".b")) and ".ln_" not in name:
            x = x.to(served)
        _set(tree, name, x.contiguous())
    blocks = tree.pop("blocks")
    tree["blocks"] = [blocks[str(i)] for i in range(layers)]
    return {"visual": tree}
