"""Weights and text bank made on the device from the seed, in a few large
draws and in the types they are served in.

The encoder's tree has the program's torch layout (linear weights [out,
in], the patch embedding [width, 3, P, P]) and the JAX package's init
scales; biases and the LayerNorms' affine parameters are drawn small
instead of 0 and 1, so that the check covers them. With a bfloat16 compute
type the linear weights and biases are bfloat16, as the fast preset serves
them (cli/common.resolve casts them once); the rest stays float32. The
head's parameters follow torch's default Linear init. The reference reads
the same tensors."""
from __future__ import annotations

import torch

from .seeds import sub_seed

AFFINE_STD = 0.02


def _gen(seed, tag, device):
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def _specs_block(width, std_qkv, std_proj, std_fc):
    return [("ln_1.scale", (width,), "ln"), ("ln_1.bias", (width,), "bias"),
            ("attn.qkv.w", (3 * width, width), std_qkv),
            ("attn.qkv.b", (3 * width,), "bias"),
            ("attn.out.w", (width, width), std_proj),
            ("attn.out.b", (width,), "bias"),
            ("ln_2.scale", (width,), "ln"), ("ln_2.bias", (width,), "bias"),
            ("mlp.fc.w", (4 * width, width), std_fc),
            ("mlp.fc.b", (4 * width,), "bias"),
            ("mlp.proj.w", (width, 4 * width), std_proj),
            ("mlp.proj.b", (width,), "bias")]


def _set(tree, dotted, value):
    parts = dotted.split(".")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def clip_visual(ccfg, seed: int, device) -> dict:
    """{"visual": tree} of the program's encoder."""
    w, layers = ccfg.vision_width, ccfg.vision_layers
    std = w ** -0.5
    proj_std = std * (2 * layers) ** -0.5
    specs = [("patch_embed", (w, 3, ccfg.patch_size, ccfg.patch_size), std),
             ("class_embedding", (w,), std),
             ("positional_embedding", (ccfg.pretrain_grid ** 2 + 1, w), std),
             ("ln_pre.scale", (w,), "ln"), ("ln_pre.bias", (w,), "bias")]
    for i in range(layers):
        specs += [(f"blocks.{i}.{n}", s, d)
                  for n, s, d in _specs_block(w, std, proj_std,
                                              (2 * w) ** -0.5)]
    specs += [("ln_post.scale", (w,), "ln"), ("ln_post.bias", (w,), "bias"),
              ("proj", (w, ccfg.embed_dim), std)]
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
        if name.endswith((".w", ".b")) and ".ln_" not in name:
            x = x.to(served)
        _set(tree, name, x.contiguous())
    blocks = tree.pop("blocks")
    tree["blocks"] = [blocks[str(i)] for i in range(layers)]
    return {"visual": tree}


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def text_bank(rows: int, dim: int, seed: int, device) -> torch.Tensor:
    """Seeded unit-norm bank [rows, dim] float32, as the CLIs make it under
    --random-init (num_fg + the dataset's background rows)."""
    bank = torch.randn((rows, dim), generator=_gen(seed, "text", device),
                       device=device)
    return bank / bank.norm(dim=-1, keepdim=True)


def head_specs(hcfg, num_classes: int) -> list:
    d, c = hcfg.embedding_dim, hcfg.in_channels
    specs = []
    for i in range(hcfg.num_blocks):
        specs += [(f"fuse_mlps.{i}.proj.w", (d, c), c),
                  (f"fuse_mlps.{i}.proj.b", (d,), c),
                  (f"fuse_mlps.{i}.proj2.w", (d, d), d),
                  (f"fuse_mlps.{i}.proj2.b", (d,), d)]
    specs += [("linear_fuse.w", (d, d * hcfg.num_blocks), d * hcfg.num_blocks),
              ("linear_fuse.b", (d,), d * hcfg.num_blocks)]
    for i in range(hcfg.decoder_layers):
        p = f"decoder.{i}."
        specs += [(p + "ln_1.scale", (d,), "ln"), (p + "ln_1.bias", (d,), "bias"),
                  (p + "attn.qkv.w", (3 * d, d), d),
                  (p + "attn.qkv.b", (3 * d,), d),
                  (p + "attn.out.w", (d, d), d), (p + "attn.out.b", (d,), d),
                  (p + "ln_2.scale", (d,), "ln"), (p + "ln_2.bias", (d,), "bias"),
                  (p + "mlp.fc.w", (4 * d, d), d), (p + "mlp.fc.b", (4 * d,), d),
                  (p + "mlp.proj.w", (d, 4 * d), 4 * d),
                  (p + "mlp.proj.b", (d,), 4 * d)]
    specs += [("classifier.w", (num_classes, d), d),
              ("classifier.b", (num_classes,), d)]
    return specs


def head_state(hcfg, num_classes: int, seed: int, device) -> dict:
    """{parameter name: float32 tensor}: U(+-1/sqrt(fan_in)) for linear
    weights and biases, LayerNorm affine drawn small around (1, 0)."""
    specs = head_specs(hcfg, num_classes)
    total = sum(_numel(s) for _, s, _ in specs)
    g = _gen(seed, "head", device)
    uni = torch.rand(total, generator=g, device=device) * 2 - 1
    state = {}
    pos = 0
    for name, shape, kind in specs:
        n = _numel(shape)
        x = uni[pos:pos + n].reshape(shape)
        pos += n
        if kind == "ln":
            x = 1.0 + AFFINE_STD * x
        elif kind == "bias":
            x = AFFINE_STD * x
        else:
            x = x * kind ** -0.5
        state[name] = x.contiguous()
    return state
