"""SigLIP So400m/14's vision tower drawn on the device from the seed, as
harness/weights.py draws OpenAI's: one large draw, the program's torch
layout (linear weights [out, in], the patch embedding [width, 3, P, P]),
the JAX package's init scales, biases and LayerNorm affine parameters drawn
small around 0 and 1, linear weights and biases in the compute type.

SigLIP's leaves (models/params.py): `patch_bias`, a positional table of
the grid alone [S*S, width] (no class embedding), blocks whose MLP has the
configuration's hidden width (4,304), no `ln_pre` and no `proj`, and the
attention-pooling head `map_head`: `probe` [1, width], `attn.qkv` (the
head's in_proj, q|k|v) and `attn.out`, the LayerNorm `ln`, and an MLP
`mlp.fc` / `mlp.proj` at the same hidden width."""
from __future__ import annotations

import torch

from .weights import AFFINE_STD, _gen, _numel, _set


def _specs_mlp(prefix, width, hidden, std_proj, std_fc):
    return [(prefix + "mlp.fc.w", (hidden, width), std_fc),
            (prefix + "mlp.fc.b", (hidden,), "bias"),
            (prefix + "mlp.proj.w", (width, hidden), std_proj),
            (prefix + "mlp.proj.b", (width,), "bias")]


def _specs_attn(prefix, width, std_qkv, std_proj):
    return [(prefix + "attn.qkv.w", (3 * width, width), std_qkv),
            (prefix + "attn.qkv.b", (3 * width,), "bias"),
            (prefix + "attn.out.w", (width, width), std_proj),
            (prefix + "attn.out.b", (width,), "bias")]


def clip_visual(ccfg, seed: int, device) -> dict:
    """{"visual": tree} of the program's SigLIP encoder."""
    w, layers, h = ccfg.vision_width, ccfg.vision_layers, ccfg.hidden
    std = w ** -0.5
    proj_std = std * (2 * layers) ** -0.5
    fc_std = (2 * w) ** -0.5
    specs = [("patch_embed", (w, 3, ccfg.patch_size, ccfg.patch_size), std),
             ("patch_bias", (w,), "bias"),
             ("positional_embedding", (ccfg.pretrain_grid ** 2, w), std)]
    for i in range(layers):
        p = f"blocks.{i}."
        specs += [(p + "ln_1.scale", (w,), "ln"),
                  (p + "ln_1.bias", (w,), "bias")]
        specs += _specs_attn(p, w, std, proj_std)
        specs += [(p + "ln_2.scale", (w,), "ln"),
                  (p + "ln_2.bias", (w,), "bias")]
        specs += _specs_mlp(p, w, h, proj_std, fc_std)
    specs += [("ln_post.scale", (w,), "ln"), ("ln_post.bias", (w,), "bias"),
              ("map_head.probe", (1, w), std)]
    specs += _specs_attn("map_head.", w, std, proj_std)
    specs += [("map_head.ln.scale", (w,), "ln"),
              ("map_head.ln.bias", (w,), "bias")]
    specs += _specs_mlp("map_head.", w, h, proj_std, fc_std)
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
        elif kind == "bias":
            x = AFFINE_STD * x
        else:
            x = x * kind
        if name.endswith((".w", ".b")):
            x = x.to(served)
        _set(tree, name, x.contiguous())
    blocks = tree.pop("blocks")
    tree["blocks"] = [blocks[str(i)] for i in range(layers)]
    return {"visual": tree}
