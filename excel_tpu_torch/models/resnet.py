"""Vanilla CLIP's ModifiedResNet vision tower (counterpart of
excel_tpu/models/resnet.py).

No ExCEL entry point runs it: it is a library model for users who hold
RN50-family CLIP weights. The differences from torchvision's ResNet are the
reference's:
- a 3-conv stem (stride 2 on conv1) and AvgPool2d(2), not 1 conv + maxpool;
- anti-aliased downsampling: a strided convolution becomes a stride-1
  convolution after AvgPool2d(stride), in the residual branch and in the
  downsample branch;
- attention pooling over the mean-prepended tokens with a learned
  positional table, resized for other input sizes, that returns ALL tokens
  [B, 1+HW, C], not only the pooled CLS.

A parameter tree and a pure forward, as models/clip.py. BatchNorm runs in
inference form (running statistics). The public contract is the JAX
package's: NHWC normalised images in. Inside, the convolutions are
`F.conv2d` in NCHW with OIHW weights, the state dict's own layout (cuDNN on
the card: `cli.common.exact_matmuls` turns its TF32 off); linear weights
are [out, in]. The JAX op order is kept where it decides the rounding: the
BatchNorm as (x - mean) * rsqrt(var + eps) * scale + bias, the average
pool as a window sum then / k^2, q scaled by d^-0.5 after its projection,
the attention logits through a float32 softmax, and the positional table
resized as `jax.image.resize(..., "bilinear")` does it: half-pixel
sampling, antialiased when it shrinks, one scale for each axis.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.labels import scale_and_translate
from .layers import linear


@dataclasses.dataclass(frozen=True)
class ResNetClipConfig:
    """ModifiedResNet tower hyperparameters."""
    layers: tuple[int, ...] = (3, 4, 6, 3)          # RN50
    width: int = 64
    embed_dim: int = 1024                            # output (text) dim
    heads: int = 32                                  # width * 32 // 64
    image_size: int = 224

    @property
    def feat_dim(self) -> int:                       # attnpool input dim
        return self.width * 32

    @property
    def pretrain_grid(self) -> int:
        return self.image_size // 32


# ---------------------------------------------------------------------------
# primitives (NCHW)
# ---------------------------------------------------------------------------

def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
          padding: int = 0) -> torch.Tensor:
    return F.conv2d(x, w, stride=stride, padding=padding)


def _bn(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    def c(v):
        return v[:, None, None]
    inv = torch.rsqrt(p["var"] + eps)
    return (x - c(p["mean"])) * c(inv) * c(p["scale"]) + c(p["bias"])


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 1:
        return x
    s = F.avg_pool2d(x, k, stride=k, divisor_override=1)   # window sum
    return s / (k * k)


def _bottleneck(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    """1x1 -> 3x3 -> avgpool(stride) -> 1x1, with an avgpool-then-1x1
    downsample branch when the shape changes."""
    out = torch.relu(_bn(_conv(x, p["conv1"]), p["bn1"]))
    out = torch.relu(_bn(_conv(out, p["conv2"], padding=1), p["bn2"]))
    out = _avg_pool(out, stride)
    out = _bn(_conv(out, p["conv3"]), p["bn3"])
    if "downsample" in p:
        x = _bn(_conv(_avg_pool(x, stride), p["downsample"]["conv"]),
                p["downsample"]["bn"])
    return torch.relu(out + x)


def resize_pos_grid(pos: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The [1+S*S, C] positional table with its grid resized to h x w as
    `jax.image.resize(grid, (h, w, C), "bilinear")` resizes it: half-pixel
    sampling, the triangle kernel widened by 1 / scale where an axis
    shrinks, one scale for each axis. `F.interpolate` would not
    antialias."""
    c = pos.shape[-1]
    side = int(round((pos.shape[0] - 1) ** 0.5))
    grid = pos[1:].reshape(side, side, c).permute(2, 0, 1)[None]
    scale = torch.tensor([[h / side, w / side]], dtype=torch.float32,
                         device=pos.device)
    grid = scale_and_translate(grid, (h, w), scale, torch.zeros_like(scale),
                               antialias=True)
    return torch.cat([pos[:1], grid[0].permute(1, 2, 0).reshape(h * w, c)
                      .to(pos.dtype)], dim=0)


def _attention_pool(p: dict, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Mean-prepended QKV attention pooling over x [B, C, h, w]; returns all
    tokens [B, 1+hw, out_dim]."""
    b, c, h, w = x.shape
    tokens = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)

    pos = p["positional_embedding"]                  # [1+S*S, C]
    side = int(round((pos.shape[0] - 1) ** 0.5))
    if side != h or h != w:
        pos = resize_pos_grid(pos, h, w)
    y = tokens + pos[None]

    d = c // heads
    n = y.shape[1]

    def split(t):
        return t.reshape(b, n, heads, d).transpose(1, 2)

    q = split(linear(y, p["q_proj"])) * (d ** -0.5)
    k = split(linear(y, p["k_proj"]))
    v = split(linear(y, p["v_proj"]))
    logits = torch.matmul(q, k.transpose(-1, -2))
    attn = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
    o = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
    return linear(o, p["c_proj"])


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def resnet_forward(params: dict, images: torch.Tensor,
                   cfg: ResNetClipConfig) -> torch.Tensor:
    """images: [B, H, W, 3] normalised, on the parameters' device. Returns
    [B, 1+HW/1024, embed_dim]: the CLS token first, then the
    1/32-resolution token map, row by row."""
    x = images.permute(0, 3, 1, 2)
    for i in (1, 2, 3):
        x = torch.relu(_bn(_conv(x, params[f"conv{i}"],
                                 stride=2 if i == 1 else 1, padding=1),
                           params[f"bn{i}"]))
    x = _avg_pool(x, 2)
    for li, blocks in enumerate(params["layers"]):
        stride = 1 if li == 0 else 2
        for bi, bp in enumerate(blocks):
            x = _bottleneck(bp, x, stride if bi == 0 else 1)
    return _attention_pool(params["attnpool"], x, cfg.heads)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def is_resnet_state_dict(sd: dict) -> bool:
    """ResNet CLIPs have visual.layer*.* keys."""
    return any(k.startswith("visual.layer1.") for k in sd)


def infer_resnet_config(sd: dict, **overrides) -> ResNetClipConfig:
    counts = []
    for li in (1, 2, 3, 4):
        blocks = {int(m.group(1)) for k in sd
                  if (m := re.match(rf"visual\.layer{li}\.(\d+)\.", k))}
        counts.append(len(blocks))
    width = sd["visual.conv1.weight"].shape[0] * 2
    embed_dim = sd["visual.attnpool.c_proj.weight"].shape[0]
    grid = int(round((sd["visual.attnpool.positional_embedding"].shape[0]
                      - 1) ** 0.5))
    kwargs = dict(layers=tuple(counts), width=width, embed_dim=embed_dim,
                  heads=width * 32 // 64, image_size=grid * 32)
    kwargs.update(overrides)
    return ResNetClipConfig(**kwargs)


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")
                            ).to(device)


def _bn_from_torch(sd: dict, prefix: str, device) -> dict:
    return {k: _tensor(sd[f"{prefix}.{name}"], device) for k, name in (
        ("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
        ("var", "running_var"))}


def _linear_from_torch(sd: dict, prefix: str, device) -> dict:
    return {"w": _tensor(sd[prefix + ".weight"], device),
            "b": _tensor(sd[prefix + ".bias"], device)}


def convert_resnet_tower(sd: dict, cfg: ResNetClipConfig,
                         device="cuda") -> dict:
    """An OpenAI RN state dict ('visual.' prefix; numpy or tensor values)
    -> the port's parameter tree on `device`: convolutions OIHW and linear
    weights [out, in], as the state dict holds them."""
    device = resolve_device(device)
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v)) for k, v in sd.items()}

    def conv(key):
        return _tensor(sd[key], device)

    params: dict = {}
    for i in (1, 2, 3):
        params[f"conv{i}"] = conv(f"visual.conv{i}.weight")
        params[f"bn{i}"] = _bn_from_torch(sd, f"visual.bn{i}", device)
    layers = []
    for li, n_blocks in enumerate(cfg.layers, start=1):
        blocks = []
        for bi in range(n_blocks):
            pre = f"visual.layer{li}.{bi}"
            bp = {}
            for j in (1, 2, 3):
                bp[f"conv{j}"] = conv(f"{pre}.conv{j}.weight")
                bp[f"bn{j}"] = _bn_from_torch(sd, f"{pre}.bn{j}", device)
            if pre + ".downsample.0.weight" in sd:
                bp["downsample"] = {
                    "conv": conv(pre + ".downsample.0.weight"),
                    "bn": _bn_from_torch(sd, pre + ".downsample.1", device)}
            blocks.append(bp)
        layers.append(blocks)
    params["layers"] = layers
    ap = "visual.attnpool"
    params["attnpool"] = {
        "positional_embedding": _tensor(sd[ap + ".positional_embedding"],
                                        device),
        **{name: _linear_from_torch(sd, f"{ap}.{name}", device)
           for name in ("q_proj", "k_proj", "v_proj", "c_proj")}}
    return params


def _from_jax(tree, key, device):
    if isinstance(tree, dict):
        return {k: _from_jax(v, k, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_from_jax(v, key, device) for v in tree]
    a = np.asarray(tree)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)                  # HWIO -> OIHW
    elif key == "w":
        a = a.T                                      # [in, out] -> [out, in]
    return _tensor(a, device)


def from_jax_resnet_params(tree: dict, cfg: ResNetClipConfig,
                           device="cuda") -> dict:
    """The JAX package's ResNet parameter tree (numpy or array leaves:
    convolutions HWIO, linear weights [in, out]) -> the port's tree on
    `device`."""
    device = resolve_device(device)
    blocks = tuple(len(b) for b in tree["layers"])
    if blocks != tuple(cfg.layers):
        raise ValueError(f"tree has blocks {blocks}, config {cfg.layers}")
    return _from_jax(tree, None, device)
