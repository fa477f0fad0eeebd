"""The LVC head, the only trained part of ExCEL (counterpart of
excel_tpu/models/head.py): per-block fuse MLPs (Linear-ReLU-Linear), a
channel-mixing fuse with Dropout2d, a 3-layer post-LN transformer decoder
with QuickGELU MLPs, and the classifier; plus the feature affinity
`attn_pred`.

`LvcHead` is an nn.Module whose parameters mirror the JAX package's head
tree name for name (`fuse_mlps.0.proj.w`, `decoder.1.attn.qkv.b`, ...,
`classifier.w`), held in nn.ParameterDicts so that the port's functional
layers (`linear`, `layer_norm`, `mlp`) take them as they are. Linear
weights are in torch's [out, in] layout; the JAX tree's are [in, out]
(models/params.head_from_jax_params transposes them). Layout: tokens-major
[B, hw, D] throughout, as in the JAX package; every op is a plain PyTorch op
(there is no Pallas kernel in the head) and differentiable.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..config import HeadConfig
from ..device import resolve_device
from ..parallel.distributed import group_mean, rank, world
from .layers import layer_norm, linear, mlp, multi_head_attention


def _linear_params(g: torch.Generator, fan_in: int,
                   fan_out: int) -> nn.ParameterDict:
    """torch's default Linear init, U(+-1/sqrt(fan_in)) for weight and
    bias, drawn from `g`."""
    bound = fan_in ** -0.5

    def uniform(*shape):
        return nn.Parameter((torch.rand(shape, generator=g) * 2 - 1) * bound)

    return nn.ParameterDict({"w": uniform(fan_out, fan_in),
                             "b": uniform(fan_out)})


def _ln_params(d: int) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": nn.Parameter(torch.ones(d)),
                             "bias": nn.Parameter(torch.zeros(d))})


class LvcHead(nn.Module):
    """The head's parameters (see the module docstring for their names);
    `segformer_fuse` and `decoder_forward` run it."""

    def __init__(self, cfg: HeadConfig, num_classes: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        d = cfg.embedding_dim
        self.cfg = cfg
        self.fuse_mlps = nn.ModuleList(
            nn.ModuleDict({"proj": _linear_params(g, cfg.in_channels, d),
                           "proj2": _linear_params(g, d, d)})
            for _ in range(cfg.num_blocks))
        self.linear_fuse = _linear_params(g, d * cfg.num_blocks, d)
        self.decoder = nn.ModuleList(
            nn.ModuleDict({
                "ln_1": _ln_params(d),
                "attn": nn.ModuleDict({"qkv": _linear_params(g, d, 3 * d),
                                       "out": _linear_params(g, d, d)}),
                "ln_2": _ln_params(d),
                "mlp": nn.ModuleDict({"fc": _linear_params(g, d, 4 * d),
                                      "proj": _linear_params(g, 4 * d, d)}),
            }) for _ in range(cfg.decoder_layers))
        self.classifier = _linear_params(g, d, num_classes)


def init_head_params(cfg: HeadConfig, num_classes: int,
                     generator: torch.Generator | None = None,
                     device="cuda") -> LvcHead:
    """A new head with torch-default inits drawn on the CPU from
    `generator` (seed 0 when None), moved to `device`."""
    return LvcHead(cfg, num_classes, generator).to(resolve_device(device))


def dropout2d(x: torch.Tensor, rate: float,
              generator: torch.Generator) -> torch.Tensor:
    """torch Dropout2d on tokens-major [B, hw, C]: whole channels are kept
    per sample with probability 1 - rate (one draw per (b, c)) and scaled
    by 1 / (1 - rate). Under a process group x is rank r's rows of a
    batch of B * world; the draw is the whole batch's [B * world, 1, C] and
    the rank keeps rows [r*B, (r+1)*B), so the ranks drop what one process
    of the whole batch would."""
    b, _, c = x.shape
    r, w = rank(), world()
    keep = torch.rand((b * w, 1, c), generator=generator,
                      device=x.device)[r * b:(r + 1) * b] < 1.0 - rate
    return x * keep / (1.0 - rate)


def segformer_fuse(head: LvcHead, feats: torch.Tensor,
                   dropout_generator: torch.Generator | None = None,
                   dropout_rate: float = 0.0) -> torch.Tensor:
    """feats [num_blocks, B, hw, in_channels] -> fused [B, hw, D] in fp32.
    Dropout2d runs only when a generator is given (training), over the
    process group's batch."""
    outs = []
    for i, p in enumerate(head.fuse_mlps):
        x = linear(feats[i].float(), p["proj"])
        outs.append(linear(torch.relu(x), p["proj2"]))
    fused = linear(torch.cat(outs, dim=-1), head.linear_fuse)
    if dropout_generator is not None and dropout_rate > 0.0:
        fused = dropout2d(fused, dropout_rate, dropout_generator)
    return fused


def decoder_forward(head: LvcHead, x: torch.Tensor):
    """x [B, hw, D] -> (logits [B, hw, num_classes], head-mean decoder
    attention [layers, B, hw, hw])."""
    attns = []
    for blk in head.decoder:
        y, w = multi_head_attention(layer_norm(x, blk["ln_1"]), blk["attn"],
                                    head.cfg.decoder_heads)
        x = x + y
        x = x + mlp(layer_norm(x, blk["ln_2"]), blk["mlp"])
        attns.append(w)
    return linear(x, head.classifier), torch.stack(attns, dim=0)


def feature_affinity(fused: torch.Tensor,
                     global_batch: bool = False) -> torch.Tensor:
    """attn_pred: sigmoid(3 (g - mean g)) of the gram g of the
    channel-normalised features [B, hw, C]; the mean is GLOBAL over the
    whole batch tensor. Returns [B, hw, hw] fp32.

    global_batch: under a process group the mean is the whole group's
    batch's, as in the JAX package's mesh (`group_mean`, differentiable);
    at world size 1 the local mean bit for bit."""
    f = fused.float()
    f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True),
                        min=1e-12)
    g = torch.matmul(f, f.transpose(1, 2))
    mean = group_mean(g.mean()) if global_batch else g.mean()
    return torch.sigmoid((g - mean) * 3.0)
