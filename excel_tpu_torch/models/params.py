"""CLIP parameters in torch layout: random init, conversion from and to the
JAX package's parameter tree, reading and writing its `save_params_npz`
files, conversion of an OpenAI CLIP state dict into that tree, and the
one-time bf16 copy of the matmul weights for the fast preset; and the LVC
head's conversion from and to the JAX package's head tree.

The tree keeps the JAX package's keys ({"visual": ..., "text": ...,
"logit_scale": ...}); the leaves change layout:
- linear weights ("w" under qkv/out/fc/proj) go from [in, out] to torch's
  [out, in]; the fused qkv projection stays one [3*width, width] weight;
- the patch embedding goes from HWIO to OIHW [width, 3, P, P];
- embeddings, LayerNorms, `visual.proj` and `text.text_projection`
  ([width, embed], applied as x @ proj) keep their layout.

An EVA-02 tower (`ClipConfig.block` "eva02", `convert_eva_state_dict`)
has no `ln_pre` and more leaves: `visual.patch_bias` [width] and
`visual.proj_bias` [embed] (its head's biases), `attn.ln_inner` (the
sub-LayerNorm on the context), its q, k and v weights stored fused as
`attn.qkv` with k's bias zero, and the SwiGLU as `mlp.fc` (W1 and W2
stacked, [2 h, width]), `mlp.ln_ffn` [h] and `mlp.proj` (W3, [width, h]).
The port's trees (`init_clip_params`, `from_jax_params`) hold the SwiGLU's
hidden padded with zero weights to whole 16-byte rows (`pad_swiglu`); the
converter's files keep the published h.

A SigLIP tower (`ClipConfig.block` "siglip", `convert_siglip_state_dict`)
has no `ln_pre`, no `class_embedding` and no `proj`: a `visual.patch_bias`
[width], a positional table of the grid alone [S*S, width], its q, k and v
stored fused as `attn.qkv`, and the attention-pooling head
`visual.map_head`: `probe` [1, width], `attn.qkv` (the head's in_proj,
q|k|v), `attn.out`, a LayerNorm `ln` and an MLP `mlp.fc` / `mlp.proj`. Its
text tower's head is `text.text_projection` [width, embed] (the Linear's
weight transposed) with `text.text_projection_bias` [embed].
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

from ..config import BACKBONES, ClipConfig, HeadConfig
from ..device import resolve_device

_LINEAR_KEYS = ("qkv", "out", "fc", "proj")


# ---------------------------------------------------------------------------
# random init (tests, smoke runs)
# ---------------------------------------------------------------------------

def _normal(g: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=torch.float32) * std


def _ln_init(width: int) -> dict:
    return {"scale": torch.ones(width), "bias": torch.zeros(width)}


def _init_block(g: torch.Generator, width: int, scale_attn: float,
                scale_proj: float, scale_fc: float,
                swiglu: int = 0, hidden: int = 0) -> dict:
    """A block's parameters with an MLP of hidden width `hidden` (0: 4 x
    width); with swiglu = h, EVA-02's: the sub-LayerNorm on the context
    and a SwiGLU of hidden width h (W1|W2 stacked)."""
    hidden = swiglu or hidden or 4 * width
    fc_out = 2 * hidden if swiglu else hidden   # W1 and W2 stacked
    blk = {
        "ln_1": _ln_init(width),
        "attn": {
            "qkv": {"w": _normal(g, (3 * width, width), scale_attn),
                    "b": torch.zeros(3 * width)},
            "out": {"w": _normal(g, (width, width), scale_proj),
                    "b": torch.zeros(width)},
        },
        "ln_2": _ln_init(width),
        "mlp": {
            "fc": {"w": _normal(g, (fc_out, width), scale_fc),
                   "b": torch.zeros(fc_out)},
            "proj": {"w": _normal(g, (width, hidden), scale_proj),
                     "b": torch.zeros(width)},
        },
    }
    if swiglu:
        blk["attn"]["ln_inner"] = _ln_init(width)
        blk["mlp"]["ln_ffn"] = _ln_init(swiglu)
    return blk


def init_clip_params(cfg: ClipConfig, generator: torch.Generator | None = None,
                     device="cuda") -> dict:
    """Random CLIP parameters with the JAX package's init scales, drawn on
    the CPU from `generator` (seed 0 when None) and moved to `device`, in
    the layout `cfg.block` names (an EVA-02 SwiGLU padded: `pad_swiglu`)."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    vw, tw = cfg.vision_width, cfg.text_width
    v_scale = vw ** -0.5
    attn_std = tw ** -0.5
    if cfg.block not in ("vit", "eva02", "siglip"):
        raise ValueError(f"block {cfg.block!r}: the port draws 'vit', "
                         "'eva02' or 'siglip' towers")
    swiglu = cfg.hidden if cfg.block == "eva02" else 0
    if cfg.block == "siglip":
        visual = _init_siglip_visual(g, cfg)
    else:
        visual = {
            "patch_embed": _normal(g, (vw, 3, cfg.patch_size,
                                       cfg.patch_size), v_scale),
            "class_embedding": _normal(g, (vw,), v_scale),
            "positional_embedding": _normal(
                g, (cfg.pretrain_grid ** 2 + 1, vw), v_scale),
            "ln_pre": _ln_init(vw),
            "blocks": [_init_block(g, vw, v_scale,
                                   v_scale * (2 * cfg.vision_layers) ** -0.5,
                                   (2 * vw) ** -0.5, swiglu)
                       for _ in range(cfg.vision_layers)],
            "ln_post": _ln_init(vw),
            "proj": _normal(g, (vw, cfg.embed_dim), v_scale),
        }
    if swiglu:
        del visual["ln_pre"]
        visual["patch_bias"] = torch.zeros(vw)
        visual["proj_bias"] = torch.zeros(cfg.embed_dim)
    text = {
        "token_embedding": _normal(g, (cfg.vocab_size, tw), 0.02),
        "positional_embedding": _normal(g, (cfg.context_length, tw), 0.01),
        "blocks": [_init_block(g, tw, attn_std,
                               attn_std * (2 * cfg.text_layers) ** -0.5,
                               (2 * tw) ** -0.5, hidden=cfg.text_mlp_hidden)
                   for _ in range(cfg.text_layers)],
        "ln_final": {"scale": torch.ones(tw), "bias": torch.zeros(tw)},
        "text_projection": _normal(g, (tw, cfg.embed_dim), attn_std),
    }
    if cfg.block == "siglip":
        text["text_projection_bias"] = torch.zeros(cfg.embed_dim)
    params = {"visual": visual, "text": text,
              "logit_scale": torch.tensor(math.log(1 / 0.07),
                                          dtype=torch.float32)}
    return pad_swiglu(_to_device(params, device))


def _init_siglip_visual(g: torch.Generator, cfg: ClipConfig) -> dict:
    """A SigLIP vision tree (module docstring) at the JAX package's init
    scales, the blocks' MLP and the pooling head's at hidden
    `cfg.hidden`."""
    vw = cfg.vision_width
    v_scale = vw ** -0.5
    proj = v_scale * (2 * cfg.vision_layers) ** -0.5
    head = _init_block(g, vw, v_scale, proj, (2 * vw) ** -0.5,
                       hidden=cfg.hidden)
    return {
        "patch_embed": _normal(g, (vw, 3, cfg.patch_size, cfg.patch_size),
                               v_scale),
        "patch_bias": torch.zeros(vw),
        "positional_embedding": _normal(g, (cfg.pretrain_grid ** 2, vw),
                                        v_scale),
        "blocks": [_init_block(g, vw, v_scale, proj, (2 * vw) ** -0.5,
                               hidden=cfg.hidden)
                   for _ in range(cfg.vision_layers)],
        "ln_post": _ln_init(vw),
        "map_head": {"probe": _normal(g, (1, vw), v_scale),
                     "attn": head["attn"], "ln": head["ln_2"],
                     "mlp": head["mlp"]},
    }


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device).contiguous()


# ---------------------------------------------------------------------------
# conversion from the JAX layout
# ---------------------------------------------------------------------------

def _convert(tree, path: tuple, device: torch.device):
    if isinstance(tree, dict):
        return {k: _convert(v, path + (k,), device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, path + (i,), device) for i, v in enumerate(tree)]
    a = np.asarray(tree)
    if path[-1] == "patch_embed":
        a = a.transpose(3, 2, 0, 1)                    # HWIO -> OIHW
    elif path[-1] == "w" and path[-2] in _LINEAR_KEYS:
        a = a.T                                        # [in,out] -> [out,in]
    return torch.from_numpy(np.array(a, order="C")).to(device)


def from_jax_params(tree: dict, cfg: ClipConfig, device="cuda") -> dict:
    """The JAX package's CLIP parameter tree (numpy or array leaves, as
    `jax.device_get` returns it) -> the port's torch tree on `device`
    (an EVA-02 SwiGLU padded: `pad_swiglu`)."""
    device = resolve_device(device)
    n = len(tree["visual"]["blocks"])
    if n != cfg.vision_layers:
        raise ValueError(f"tree has {n} vision blocks, config "
                         f"{cfg.vision_layers}")
    return pad_swiglu(_convert(tree, (), device))


_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _keystr_path(key: str) -> list:
    parts = [m.group(1) if m.group(1) is not None else int(m.group(2))
             for m in _KEY.finditer(key)]
    if "".join(f"['{p}']" if isinstance(p, str) else f"[{p}]"
               for p in parts) != key:
        raise ValueError(f"unrecognised parameter key {key!r}")
    return parts


def _insert(tree: dict, parts: list, value) -> None:
    node = tree
    for part, nxt in zip(parts[:-1], parts[1:]):
        child = {} if isinstance(nxt, str) else []
        if isinstance(part, int):
            while len(node) <= part:
                node.append(None)
            if node[part] is None:
                node[part] = child
            node = node[part]
        else:
            node = node.setdefault(part, child)
    last = parts[-1]
    if isinstance(last, int):
        while len(node) <= last:
            node.append(None)
    node[last] = value


def _keystr(parts) -> str:
    """jax.tree_util.keystr of a path of dict keys and list indices."""
    return "".join(f"[{p}]" if isinstance(p, int) else f"['{p}']"
                   for p in parts)


def _leaves(tree, path=()):
    """(path, leaf) pairs of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def save_npz_tree(path: str, tree) -> None:
    """One array per leaf, keyed by `jax.tree_util.keystr` of its path: the
    layout of the JAX package's `save_params_npz` and `save_head_npz`."""
    np.savez(path, **{_keystr(p): np.asarray(v) for p, v in _leaves(tree)})


def to_jax_params(params: dict) -> dict:
    """The port's torch tree -> the JAX package's layout with float32 numpy
    leaves (the inverse of `from_jax_params`; bf16 leaves widen exactly)."""
    def conv(tree, path):
        if isinstance(tree, dict):
            return {k: conv(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v, path + (i,)) for i, v in enumerate(tree)]
        a = tree.detach().float().cpu().numpy()
        if path[-1] == "patch_embed":
            a = a.transpose(2, 3, 1, 0)                # OIHW -> HWIO
        elif path[-1] == "w" and path[-2] in _LINEAR_KEYS:
            a = a.T                                    # [out,in] -> [in,out]
        return np.ascontiguousarray(a)
    return conv(params, ())


def save_params_npz(path: str, params: dict) -> None:
    """Write the port's CLIP parameters in the file format of the JAX
    package's `save_params_npz`, which `load_params_npz` reads back."""
    save_npz_tree(path, to_jax_params(params))


def load_params_npz(path: str, cfg: ClipConfig, device="cuda") -> dict:
    """Read a file written by excel_tpu.models.params.save_params_npz (one
    array per leaf, keyed by jax.tree_util.keystr of its path) without
    importing JAX, and convert it with `from_jax_params`."""
    device = resolve_device(device)
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            _insert(tree, _keystr_path(key), data[key])
    return from_jax_params(tree, cfg, device)


# ---------------------------------------------------------------------------
# OpenAI CLIP state dicts -> the JAX package's layout (numpy leaves)
# ---------------------------------------------------------------------------

def _ln(sd: dict, prefix: str) -> dict:
    return {"scale": np.asarray(sd[prefix + ".weight"]),
            "bias": np.asarray(sd[prefix + ".bias"])}


def _block_from_torch(sd: dict, prefix: str) -> dict:
    def lin(name):
        return {"w": np.ascontiguousarray(np.asarray(sd[name + "weight"]).T),
                "b": np.asarray(sd[name + "bias"])}

    return {
        "ln_1": _ln(sd, prefix + ".ln_1"),
        "attn": {"qkv": lin(prefix + ".attn.in_proj_"),
                 "out": lin(prefix + ".attn.out_proj.")},
        "ln_2": _ln(sd, prefix + ".ln_2"),
        "mlp": {"fc": lin(prefix + ".mlp.c_fc."),
                "proj": lin(prefix + ".mlp.c_proj.")},
    }


def infer_clip_config(sd: dict, backbone: str | None = None) -> ClipConfig:
    """The architecture of a CLIP state dict in OpenAI's key layout (which
    OpenCLIP's checkpoints share) or EVA-CLIP's from its tensor shapes.

    Neither the head width nor the activation is in the shapes. Without
    `backbone`, OpenAI's own rule (its `build_model`): heads = width / 64,
    QuickGELU. With a name of `config.BACKBONES`, that tower's config
    (heads, activation, image size), whose published widths the shapes
    must match (OpenCLIP ViT-H/14: width 1280 in 16 heads of 80, where
    width / 64 gives 20). An EVA-CLIP state dict needs the name: its
    rotary grid, sub-LayerNorms and eps are not in the shapes either."""
    cfg = _shape_config(sd)
    if backbone is None:
        if _is_eva(sd):
            raise ValueError("an EVA-CLIP state dict: name its backbone "
                             "(--backbone), e.g. eva02-clip-l-14-336")
        if _is_siglip(sd):
            raise ValueError("a SigLIP state dict: name its backbone "
                             "(--backbone), e.g. siglip-so400m-14-384")
        return cfg
    if backbone not in BACKBONES:
        raise ValueError(f"unknown backbone {backbone!r}; known: "
                         f"{', '.join(BACKBONES)}")
    named = ClipConfig(**BACKBONES[backbone]["full"])
    wrong = [f"{f}: {getattr(cfg, f)} in the state dict, {getattr(named, f)} "
             f"in {backbone}" for f in _SHAPE_FIELDS
             if getattr(cfg, f) != getattr(named, f)]
    if wrong:
        raise ValueError("the state dict is not " + backbone + ": "
                         + "; ".join(wrong))
    return named


# the ClipConfig fields (and properties) that a state dict's shapes and
# names determine
_SHAPE_FIELDS = ("patch_size", "vision_width", "vision_layers", "embed_dim",
                 "pretrain_grid", "context_length", "vocab_size",
                 "text_width", "text_layers", "hidden", "block")


def _is_eva(sd: dict) -> bool:
    """EVA-CLIP's key layout (its EVAVisionTransformer's names)."""
    return "visual.patch_embed.proj.weight" in sd


def _is_siglip(sd: dict) -> bool:
    """transformers' SiglipModel key layout."""
    return "vision_model.embeddings.patch_embedding.weight" in sd


def _text_keys(sd: dict) -> dict:
    """The text tower's keys in OpenAI's layout: EVA-CLIP's custom text
    tower prefixes them with "text."."""
    return {(k[5:] if k.startswith("text.") else k): v
            for k, v in sd.items()}


def _count(sd: dict, pattern: str) -> int:
    return len({int(m.group(1)) for k in sd if (m := re.match(pattern, k))})


def _shape_config(sd: dict) -> ClipConfig:
    if _is_siglip(sd):
        v, t = "vision_model.", "text_model."
        w = sd[v + "embeddings.patch_embedding.weight"]
        tpos = sd[t + "embeddings.position_embedding.weight"]
        return ClipConfig(
            patch_size=w.shape[-1], vision_width=w.shape[0],
            vision_layers=_count(sd,
                                 r"vision_model\.encoder\.layers\.(\d+)\."),
            vision_heads=w.shape[0] // 64,
            pretrain_grid=int(round(sd[v + "embeddings.position_embedding."
                                       "weight"].shape[0] ** 0.5)),
            mlp_hidden=sd[v + "encoder.layers.0.mlp.fc1.weight"].shape[0],
            block="siglip", embed_dim=sd[t + "head.weight"].shape[0],
            context_length=tpos.shape[0],
            vocab_size=sd[t + "embeddings.token_embedding.weight"].shape[0],
            text_width=tpos.shape[1], text_heads=tpos.shape[1] // 64,
            text_layers=_count(sd, r"text_model\.encoder\.layers\.(\d+)\."))
    if _is_eva(sd):
        w = sd["visual.patch_embed.proj.weight"]
        pos = sd["visual.pos_embed"]
        vision = dict(
            patch_size=w.shape[-1], vision_width=w.shape[0],
            vision_layers=_count(sd, r"visual\.blocks\.(\d+)\."),
            pretrain_grid=int(round((pos.shape[-2] - 1) ** 0.5)),
            mlp_hidden=sd["visual.blocks.0.mlp.w1.weight"].shape[0],
            block="eva02")
        sd = _text_keys(sd)
    else:
        w = sd["visual.conv1.weight"]
        vision = dict(
            patch_size=w.shape[-1], vision_width=w.shape[0],
            vision_layers=_count(
                sd, r"visual\.transformer\.resblocks\.(\d+)\."),
            pretrain_grid=int(round(
                (sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)))
    text_width = sd["positional_embedding"].shape[1]
    return ClipConfig(
        **vision,
        vision_heads=vision["vision_width"] // 64,
        embed_dim=sd["text_projection"].shape[1],
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        text_width=text_width,
        text_heads=text_width // 64,
        text_layers=_count(sd, r"transformer\.resblocks\.(\d+)\."),
    )


def _eva_block(sd: dict, prefix: str) -> dict:
    """One EVA-CLIP vision block (EVA-02's Block: norm1, attn with q_proj /
    k_proj / v_proj, q_bias / v_bias, inner_attn_ln and proj, norm2, mlp
    w1 / w2 / ffn_ln / w3) in the port's tree, JAX layout."""
    a, m = prefix + ".attn.", prefix + ".mlp."

    def lin(name):
        return {"w": np.ascontiguousarray(sd[name + ".weight"].T),
                "b": sd[name + ".bias"]}

    q_b = sd[a + "q_bias"]
    qkv_w = np.concatenate([sd[a + n + "_proj.weight"] for n in "qkv"])
    fc_w = np.concatenate([sd[m + "w1.weight"], sd[m + "w2.weight"]])
    return {
        "ln_1": _ln(sd, prefix + ".norm1"),
        "attn": {"qkv": {"w": np.ascontiguousarray(qkv_w.T),
                         "b": np.concatenate([q_b, np.zeros_like(q_b),
                                              sd[a + "v_bias"]])},
                 "ln_inner": _ln(sd, a + "inner_attn_ln"),
                 "out": lin(a + "proj")},
        "ln_2": _ln(sd, prefix + ".norm2"),
        "mlp": {"fc": {"w": np.ascontiguousarray(fc_w.T),
                       "b": np.concatenate([sd[m + "w1.bias"],
                                            sd[m + "w2.bias"]])},
                "ln_ffn": _ln(sd, m + "ffn_ln"),
                "proj": lin(m + "w3")},
    }


def convert_eva_state_dict(sd: dict, cfg: ClipConfig) -> dict:
    """A numpy-valued EVA-CLIP state dict (EVAVisionTransformer under
    "visual.", OpenAI's text names, with or without EVA's "text." prefix)
    -> the port's tree in the JAX package's layout (numpy leaves, linear
    weights [in, out], the patch embedding HWIO). The rotary tables in
    the checkpoint ("visual.rope.*") are not read: the port forms them
    for each grid (models/layers.rope_table)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    width = cfg.vision_width
    visual = {
        "patch_embed": np.ascontiguousarray(
            sd["visual.patch_embed.proj.weight"].transpose(2, 3, 1, 0)),
        "patch_bias": sd["visual.patch_embed.proj.bias"],
        "class_embedding": sd["visual.cls_token"].reshape(width),
        "positional_embedding": sd["visual.pos_embed"].reshape(-1, width),
        "blocks": [_eva_block(sd, f"visual.blocks.{i}")
                   for i in range(cfg.vision_layers)],
        "ln_post": _ln(sd, "visual.norm"),
        "proj": np.ascontiguousarray(sd["visual.head.weight"].T),
        "proj_bias": sd["visual.head.bias"],
    }
    tree = _convert_text(_text_keys(sd), cfg)
    tree["visual"] = visual
    return tree


def _convert_text(sd: dict, cfg: ClipConfig) -> dict:
    """{"text": ..., "logit_scale": ...} of OpenAI's text names."""
    text = {
        "token_embedding": sd["token_embedding.weight"],
        "positional_embedding": sd["positional_embedding"],
        "blocks": [_block_from_torch(sd, f"transformer.resblocks.{i}")
                   for i in range(cfg.text_layers)],
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": sd["text_projection"],
    }
    return {"text": text, "logit_scale": sd["logit_scale"]}


def _siglip_block(sd: dict, prefix: str) -> dict:
    """One SiglipEncoderLayer (layer_norm1, self_attn.{q,k,v,out}_proj,
    layer_norm2, mlp.fc1 / fc2) in the port's tree, JAX layout."""
    a, m = prefix + ".self_attn.", prefix + ".mlp."

    def lin(name):
        return {"w": np.ascontiguousarray(sd[name + ".weight"].T),
                "b": sd[name + ".bias"]}

    qkv_w = np.concatenate([sd[a + n + "_proj.weight"] for n in "qkv"])
    return {
        "ln_1": _ln(sd, prefix + ".layer_norm1"),
        "attn": {"qkv": {"w": np.ascontiguousarray(qkv_w.T),
                         "b": np.concatenate([sd[a + n + "_proj.bias"]
                                              for n in "qkv"])},
                 "out": lin(a + "out_proj")},
        "ln_2": _ln(sd, prefix + ".layer_norm2"),
        "mlp": {"fc": lin(m + "fc1"), "proj": lin(m + "fc2")},
    }


def convert_siglip_state_dict(sd: dict, cfg: ClipConfig) -> dict:
    """A numpy-valued transformers SiglipModel state dict (vision_model.*,
    text_model.*, logit_scale) -> the port's tree in the JAX package's
    layout (numpy leaves, linear weights [in, out], the patch embedding
    HWIO; module docstring for the SigLIP leaves). The head's in_proj
    stays fused as `map_head.attn.qkv`."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    v, t = "vision_model.", "text_model."
    hd = v + "head."

    def lin(name):
        return {"w": np.ascontiguousarray(sd[name + ".weight"].T),
                "b": sd[name + ".bias"]}

    visual = {
        "patch_embed": np.ascontiguousarray(
            sd[v + "embeddings.patch_embedding.weight"].transpose(2, 3, 1,
                                                                  0)),
        "patch_bias": sd[v + "embeddings.patch_embedding.bias"],
        "positional_embedding": sd[v + "embeddings.position_embedding."
                                       "weight"],
        "blocks": [_siglip_block(sd, f"{v}encoder.layers.{i}")
                   for i in range(cfg.vision_layers)],
        "ln_post": _ln(sd, v + "post_layernorm"),
        "map_head": {
            "probe": sd[hd + "probe"].reshape(1, -1),
            "attn": {"qkv": {"w": np.ascontiguousarray(
                                 sd[hd + "attention.in_proj_weight"].T),
                             "b": sd[hd + "attention.in_proj_bias"]},
                     "out": lin(hd + "attention.out_proj")},
            "ln": _ln(sd, hd + "layernorm"),
            "mlp": {"fc": lin(hd + "mlp.fc1"), "proj": lin(hd + "mlp.fc2")},
        },
    }
    text = {
        "token_embedding": sd[t + "embeddings.token_embedding.weight"],
        "positional_embedding": sd[t + "embeddings.position_embedding."
                                       "weight"],
        "blocks": [_siglip_block(sd, f"{t}encoder.layers.{i}")
                   for i in range(cfg.text_layers)],
        "ln_final": _ln(sd, t + "final_layer_norm"),
        "text_projection": np.ascontiguousarray(sd[t + "head.weight"].T),
        "text_projection_bias": sd[t + "head.bias"],
    }
    return {"visual": visual, "text": text,
            "logit_scale": sd["logit_scale"].reshape(())}


def convert_torch_state_dict(sd: dict, cfg: ClipConfig) -> dict:
    """A numpy-valued OpenAI CLIP state dict -> the JAX package's parameter
    tree with numpy leaves (linear weights [in, out], the patch embedding
    HWIO), as `save_npz_tree` writes it and `from_jax_params` reads it;
    an EVA-CLIP one through `convert_eva_state_dict`, a SigLIP one
    through `convert_siglip_state_dict`."""
    if _is_eva(sd):
        return convert_eva_state_dict(sd, cfg)
    if _is_siglip(sd):
        return convert_siglip_state_dict(sd, cfg)
    sd = {k: np.asarray(v) for k, v in sd.items()}
    visual = {
        "patch_embed": np.ascontiguousarray(
            sd["visual.conv1.weight"].transpose(2, 3, 1, 0)),  # OIHW->HWIO
        "class_embedding": sd["visual.class_embedding"],
        "positional_embedding": sd["visual.positional_embedding"],
        "ln_pre": _ln(sd, "visual.ln_pre"),
        "blocks": [_block_from_torch(sd, f"visual.transformer.resblocks.{i}")
                   for i in range(cfg.vision_layers)],
        "ln_post": _ln(sd, "visual.ln_post"),
        "proj": sd["visual.proj"],
    }
    return {"visual": visual, **_convert_text(sd, cfg)}


def cast_matmul_weights(params: dict, dtype: torch.dtype) -> dict:
    """One-time copy of the matmul weights ('w'/'b' leaves) in `dtype`.

    layers.linear casts weights to the activation type at every use; with
    fp32-stored weights in bf16 compute mode that reads and converts every
    frozen weight at every forward. Casting once up front makes the per-use
    cast a no-op with the same results. Only apply alongside a bf16
    compute_dtype; LayerNorm, embedding and projection leaves stay fp32."""
    def walk(d):
        if isinstance(d, dict):
            return {k: (v.to(dtype) if k in ("w", "b")
                        and isinstance(v, torch.Tensor) else walk(v))
                    for k, v in d.items()}
        if isinstance(d, (list, tuple)):
            return type(d)(walk(x) for x in d)
        return d
    return walk(params)


# the SwiGLU's padded hidden: a multiple of 8 elements, whole 16-byte rows
# in bf16 and in fp32
SWIGLU_MULTIPLE = 8


def pad_swiglu(params: dict) -> dict:
    """The tree with each SwiGLU MLP (an "mlp" holding "ln_ffn") of hidden
    width h padded with zero weights to hp, the next multiple of
    SWIGLU_MULTIPLE (2,730 -> 2,736): W1 and W2 each gain hp - h zero rows
    (fc [2 hp, C], its bias zero there) and W3 as many zero columns
    ([C, hp]); ln_ffn keeps its h. The layer computes the same numbers
    (layers.swiglu_gate writes 0 beyond h, and W3's zero columns take
    them). The gate kernel takes 16-byte rows only, and in bf16 a row of
    2,730 elements is 5,460 bytes: cuBLAS then takes 4-byte-aligned
    kernels, 3.0x slower at EVA-02's [2308, 1024] x [1024, 5460] and
    [2308, 2730] x [2730, 1024] than at hp = 2,736 (0.135 + 0.091 against
    0.045 + 0.031 ms, NVIDIA H100). A padded tree is returned as it is."""
    def pad(m):
        h = m["ln_ffn"]["scale"].shape[0]
        w, b, w3 = m["fc"]["w"], m["fc"]["b"], m["proj"]["w"]
        hp = -(-h // SWIGLU_MULTIPLE) * SWIGLU_MULTIPLE
        if w.shape[0] == 2 * hp:
            return m
        halves = w.reshape(2, h, -1)
        wp = halves.new_zeros((2, hp, w.shape[1]))
        wp[:, :h] = halves
        bp = b.new_zeros((2, hp))
        bp[:, :h] = b.reshape(2, h)
        w3p = w3.new_zeros((w3.shape[0], hp))
        w3p[:, :h] = w3
        return dict(m, fc={"w": wp.reshape(2 * hp, -1), "b": bp.reshape(-1)},
                    proj=dict(m["proj"], w=w3p))

    def walk(d):
        if isinstance(d, dict):
            if "ln_ffn" in d:
                return pad(d)
            return {k: walk(v) for k, v in d.items()}
        if isinstance(d, (list, tuple)):
            return type(d)(walk(x) for x in d)
        return d
    return walk(params)


# ---------------------------------------------------------------------------
# the LVC head
# ---------------------------------------------------------------------------

def _head_path(name: str) -> list:
    """'decoder.0.attn.qkv.w' -> ['decoder', 0, 'attn', 'qkv', 'w']."""
    return [int(p) if p.isdigit() else p for p in name.split(".")]


def head_from_jax_params(tree: dict, cfg: HeadConfig, num_classes: int,
                         device="cuda"):
    """The JAX package's head tree (numpy or array leaves) -> a new
    `LvcHead` on `device`: the same names, linear weights transposed from
    [in, out] to [out, in]."""
    from .head import LvcHead

    head = LvcHead(cfg, num_classes)
    state = {}
    for name, ref in head.state_dict().items():
        node = tree
        for part in _head_path(name):
            node = node[part]
        a = np.asarray(node, dtype=np.float32)
        if name.endswith(".w"):
            a = a.T
        if a.shape != tuple(ref.shape):
            raise ValueError(f"head parameter {name}: {a.shape}, expected "
                             f"{tuple(ref.shape)}")
        state[name] = torch.from_numpy(np.array(a, order="C"))
    head.load_state_dict(state)
    return head.to(resolve_device(device))


def head_to_jax_tree(head) -> dict:
    """An `LvcHead` -> the JAX package's head tree with numpy leaves
    (linear weights back to [in, out])."""
    tree: dict = {}
    for name, value in head.state_dict().items():
        a = value.detach().float().cpu().numpy()
        _insert(tree, _head_path(name), a.T.copy() if name.endswith(".w")
                else a)
    return tree
