"""Functional building blocks of the CLIP encoder (counterpart of
excel_tpu/models/layers.py).

Numerics as in the JAX package, for float32 and bfloat16 activations:
- `linear` casts the weight to the activation type, accumulates the product
  in fp32, rounds it to that type and then adds the bias in that type (two
  roundings in bf16, as the JAX package's `dot(...).astype(x.dtype) + b`);
- LayerNorm always computes in float32 and casts back;
- QuickGELU is x * sigmoid(1.702 x) in the activation type, written as
  JAX lowers it: 1.702 rounded to that type first (a weak-typed Python
  scalar), and the sigmoid as 1 / (1 + exp(-z)) with each op rounded
  (`torch.sigmoid` rounds once, and `1.702 * x` keeps the constant in fp32;
  each moved about a quarter of the bf16 results by an ulp);
- standard attention returns the head-MEAN of its softmax weights (torch
  nn.MultiheadAttention need_weights semantics), while the surgery attention
  returns the head-SUM of its original-path weights; SVC consumes a mix of
  both, so the distinction matters.

Parameters are the torch-layout tree of models/params.py: linear weights
[out, in], applied as x @ w^T + b.
"""
from __future__ import annotations

import torch

from ..parallel.distributed import group_mean
from ..utils import profiling
from .attention_kernels import fused_plain_attention, fused_surgery_attention


def layer_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    orig = x.dtype
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    out = (x32 - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(orig)


# 1.702 rounded to each activation type on the host: a Python float that
# the product takes as is (a device tensor would cost a blocking copy)
_GELU_ALPHA = {dt: float(torch.tensor(1.702, dtype=dt))
               for dt in (torch.float32, torch.bfloat16)}


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * (1.0 / (1.0 + torch.exp(-(_GELU_ALPHA[x.dtype] * x))))


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    out = torch.matmul(x, p["w"].to(x.dtype).t())
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


def mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    return linear(quick_gelu(linear(x, p["fc"])), p["proj"])


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, N, C] -> contiguous [B, heads, N, C//heads]."""
    b, n, c = x.shape
    return x.reshape(b, n, heads, c // heads).permute(0, 2, 1, 3).contiguous()


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, heads, N, D] -> [B, N, heads*D]."""
    b, h, n, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, n, h * d)


def qkv_projection(y: torch.Tensor, p: dict, heads: int):
    """Fused qkv projection -> per-head q, k, v ([B, H, N, D] each)."""
    q, k, v = linear(y, p["qkv"]).chunk(3, dim=-1)
    return split_heads(q, heads), split_heads(k, heads), split_heads(v, heads)


def _cpu_only(y: torch.Tensor, name: str) -> None:
    if y.device.type != "cpu":
        raise ValueError(f"{name} is the per-head plain version for CPU "
                         f"tensors; on {y.device} use {name}_fused")


def multi_head_attention(y: torch.Tensor, p: dict, heads: int,
                         mask: torch.Tensor | None = None):
    """Standard multi-head self-attention over pre-normed input in plain
    PyTorch ops, on any device and differentiable: the JAX package's plain
    `attention`, which it runs outside any Pallas kernel for the LVC head's
    decoder and, with a causal `mask` [N, N] (fp32, added to the logits),
    for the text tower. Its type points are kept for bf16 input: q * scale
    in the activation type, the logits formed in fp32 (bf16 products are
    exact there) plus the mask, the softmax in fp32, the weights rounded to
    v's type for the context, which is accumulated in fp32 and rounded.
    Returns (output [B, N, C], head-mean fp32 weights [B, N, N])."""
    q, k, v = qkv_projection(y, p, heads)
    scale = float(torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype))
    logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if mask is not None:
        logits = logits + mask
    weights = torch.softmax(logits, dim=-1)
    ctx = torch.matmul(weights.to(v.dtype).float(), v.float()).to(v.dtype)
    return linear(merge_heads(ctx), p["out"]), weights.mean(dim=1)


def attention(y: torch.Tensor, p: dict, heads: int):
    """`multi_head_attention` as the encoder's per-head plain version, for
    CPU tensors only (the encoder calls `attention_fused`)."""
    _cpu_only(y, "attention")
    return multi_head_attention(y, p, heads)


def surgery_attention(y: torch.Tensor, p: dict, heads: int,
                      ex_attn: torch.Tensor | None = None):
    """ExCEL dual-path attention per head in plain PyTorch: the original
    q k^T path and the dense value-value path (mean of softmax(q q^T),
    softmax(k k^T), softmax(v v^T)), optionally calibrated by the LVC
    feature affinity ex_attn [B, M, M] added to every head's patch-patch
    block, then summed over heads so every head aggregates v with one
    shared matrix. For CPU tensors only (the encoder calls
    `surgery_attention_fused`).

    Returns (dense_out, ori_out, head-summed original weights [B, N, N])."""
    _cpu_only(y, "surgery_attention")
    q, k, v = qkv_projection(y, p, heads)
    scale = q.shape[-1] ** -0.5

    def self_sim(t):
        return torch.softmax(torch.matmul(t * scale, t.transpose(-1, -2)),
                             dim=-1)

    attn_ori = torch.softmax(torch.matmul(q * scale, k.transpose(-1, -2)),
                             dim=-1)
    attn = (self_sim(q) + self_sim(k) + self_sim(v)) / 3.0
    if ex_attn is not None:
        attn = attn.clone()
        attn[:, :, 1:, 1:] += ex_attn[:, None].to(attn.dtype)
    shared = attn.sum(dim=1, keepdim=True)                 # [B,1,N,N]
    ctx_dense = torch.matmul(shared, v)
    ctx_ori = torch.matmul(attn_ori, v)
    dense_out = linear(merge_heads(ctx_dense), p["out"])
    ori_out = linear(merge_heads(ctx_ori), p["out"])
    return dense_out, ori_out, attn_ori.sum(dim=1)


def attention_fused(y: torch.Tensor, p: dict, heads: int,
                    attn_acc: torch.Tensor | None = None,
                    need_weights: bool = True):
    """`attention` (no mask) through the plain attention kernel. attn_acc:
    optional [B, N, N] fp32 accumulator the kernel adds its head-mean onto
    in place; need_weights=False skips the weights output."""
    with profiling.span("attn"):
        q, k, v = qkv_projection(y, p, heads)
        ctx, w = fused_plain_attention(q, k, v, acc=attn_acc,
                                       need_weights=need_weights)
        return linear(merge_heads(ctx), p["out"]), w


def surgery_attention_fused(y: torch.Tensor, p: dict, heads: int,
                            ex_attn: torch.Tensor | None = None,
                            attn_acc: torch.Tensor | None = None,
                            need_attn: bool = True):
    """`surgery_attention` through the surgery attention kernel; attn_acc /
    need_attn control the head-summed original weights as in
    `attention_fused`. ex_attn [B, M, M] (in the activation type) reaches
    the kernel as fp32 [B, N, N] with a zero CLS row and column, which adds
    it to the patch-patch block only. The dense context shared @ v is one
    product outside the kernel."""
    with profiling.span("attn"):
        q, k, v = qkv_projection(y, p, heads)
        ex = None
        if ex_attn is not None:
            ex = torch.nn.functional.pad(ex_attn.float(), (1, 0, 1, 0))
        shared, attn_sum, ctx_ori = fused_surgery_attention(
            q, k, v, ex_attn=ex, acc=attn_acc, need_attn=need_attn)
        ctx_dense = torch.matmul(shared[:, None].to(v.dtype), v)
        dense_out = linear(merge_heads(ctx_dense), p["out"])
        ori_out = linear(merge_heads(ctx_ori), p["out"])
        return dense_out, ori_out, attn_sum


def external_feature_attention(ex_feats: torch.Tensor, beta: float = 1.0,
                               gamma: float = 3.0,
                               global_batch: bool = False) -> torch.Tensor:
    """LVC feature-affinity calibration mask: ex_feats [B, C, H, W] ->
    softmax over the channel-normalised cosine similarity, centred on its
    mean over the WHOLE batch tensor, scaled by gamma, entries below 0 set
    to -inf; [B, HW, HW] float32. global_batch: the mean over the process
    group's batch (`parallel.distributed.group_mean`), as the JAX
    package's mesh takes it in the train step."""
    b, c, h, w = ex_feats.shape
    flat = ex_feats.reshape(b, c, h * w).float()
    flat = flat / torch.clamp(torch.linalg.vector_norm(flat, dim=1,
                                                       keepdim=True),
                              min=1e-12)
    sim = torch.matmul(flat.transpose(1, 2), flat)
    mean = group_mean(sim.mean()) if global_batch else sim.mean()
    sim = (sim - mean * beta) * gamma
    sim = torch.where(sim < 0.0, torch.full_like(sim, -torch.inf), sim)
    return torch.softmax(sim, dim=-1)
