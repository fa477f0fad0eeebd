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
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

from ..config import ClipConfig, HeadConfig
from ..device import resolve_device

_LINEAR_KEYS = ("qkv", "out", "fc", "proj")


# ---------------------------------------------------------------------------
# random init (tests, smoke runs)
# ---------------------------------------------------------------------------

def _normal(g: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=torch.float32) * std


def _init_block(g: torch.Generator, width: int, scale_attn: float,
                scale_proj: float, scale_fc: float) -> dict:
    def ln():
        return {"scale": torch.ones(width), "bias": torch.zeros(width)}

    return {
        "ln_1": ln(),
        "attn": {
            "qkv": {"w": _normal(g, (3 * width, width), scale_attn),
                    "b": torch.zeros(3 * width)},
            "out": {"w": _normal(g, (width, width), scale_proj),
                    "b": torch.zeros(width)},
        },
        "ln_2": ln(),
        "mlp": {
            "fc": {"w": _normal(g, (4 * width, width), scale_fc),
                   "b": torch.zeros(4 * width)},
            "proj": {"w": _normal(g, (width, 4 * width), scale_proj),
                     "b": torch.zeros(width)},
        },
    }


def init_clip_params(cfg: ClipConfig, generator: torch.Generator | None = None,
                     device="cuda") -> dict:
    """Random CLIP parameters with the JAX package's init scales, drawn on
    the CPU from `generator` (seed 0 when None) and moved to `device`."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    vw, tw = cfg.vision_width, cfg.text_width
    v_scale = vw ** -0.5
    attn_std = tw ** -0.5
    visual = {
        "patch_embed": _normal(g, (vw, 3, cfg.patch_size, cfg.patch_size),
                               v_scale),
        "class_embedding": _normal(g, (vw,), v_scale),
        "positional_embedding": _normal(g, (cfg.pretrain_grid ** 2 + 1, vw),
                                        v_scale),
        "ln_pre": {"scale": torch.ones(vw), "bias": torch.zeros(vw)},
        "blocks": [_init_block(g, vw, v_scale,
                               v_scale * (2 * cfg.vision_layers) ** -0.5,
                               (2 * vw) ** -0.5)
                   for _ in range(cfg.vision_layers)],
        "ln_post": {"scale": torch.ones(vw), "bias": torch.zeros(vw)},
        "proj": _normal(g, (vw, cfg.embed_dim), v_scale),
    }
    text = {
        "token_embedding": _normal(g, (cfg.vocab_size, tw), 0.02),
        "positional_embedding": _normal(g, (cfg.context_length, tw), 0.01),
        "blocks": [_init_block(g, tw, attn_std,
                               attn_std * (2 * cfg.text_layers) ** -0.5,
                               (2 * tw) ** -0.5)
                   for _ in range(cfg.text_layers)],
        "ln_final": {"scale": torch.ones(tw), "bias": torch.zeros(tw)},
        "text_projection": _normal(g, (tw, cfg.embed_dim), attn_std),
    }
    params = {"visual": visual, "text": text,
              "logit_scale": torch.tensor(math.log(1 / 0.07),
                                          dtype=torch.float32)}
    return _to_device(params, device)


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
    `jax.device_get` returns it) -> the port's torch tree on `device`."""
    device = resolve_device(device)
    n = len(tree["visual"]["blocks"])
    if n != cfg.vision_layers:
        raise ValueError(f"tree has {n} vision blocks, config "
                         f"{cfg.vision_layers}")
    return _convert(tree, (), device)


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


def infer_clip_config(sd: dict) -> ClipConfig:
    """The architecture of an OpenAI CLIP state dict from its tensor
    shapes (heads: width / 64)."""
    vision_width = sd["visual.conv1.weight"].shape[0]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1)
                     ** 0.5))

    def layers(pattern: str) -> int:
        return len({int(m.group(1)) for k in sd
                    if (m := re.match(pattern, k))})

    text_width = sd["positional_embedding"].shape[1]
    return ClipConfig(
        patch_size=sd["visual.conv1.weight"].shape[-1],
        vision_width=vision_width,
        vision_layers=layers(r"visual\.transformer\.resblocks\.(\d+)\."),
        vision_heads=vision_width // 64,
        embed_dim=sd["text_projection"].shape[1],
        pretrain_grid=grid,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        text_width=text_width,
        text_heads=text_width // 64,
        text_layers=layers(r"transformer\.resblocks\.(\d+)\."),
    )


def convert_torch_state_dict(sd: dict, cfg: ClipConfig) -> dict:
    """A numpy-valued OpenAI CLIP state dict -> the JAX package's parameter
    tree with numpy leaves (linear weights [in, out], the patch embedding
    HWIO), as `save_npz_tree` writes it and `from_jax_params` reads it."""
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
    text = {
        "token_embedding": sd["token_embedding.weight"],
        "positional_embedding": sd["positional_embedding"],
        "blocks": [_block_from_torch(sd, f"transformer.resblocks.{i}")
                   for i in range(cfg.text_layers)],
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": sd["text_projection"],
    }
    return {"visual": visual, "text": text,
            "logit_scale": sd["logit_scale"]}


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
