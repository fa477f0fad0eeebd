"""Functional building blocks of the CLIP encoder (counterpart of
excel_tpu/models/layers.py).

Numerics as in the JAX package, for float32 and bfloat16 activations:
- `linear` casts the weight to the activation type, accumulates the product
  in fp32, rounds it to that type and then adds the bias in that type (two
  roundings in bf16, as the JAX package's `dot(...).astype(x.dtype) + b`);
- LayerNorm always computes in float32 and casts back; the encoder's
  LayerNorms, and the residual add before each, run through
  `layer_norm_fused` / `add_layer_norm_fused` (csrc/layer_norm.cu on the
  card, the same arithmetic);
- the encoder's qkv bias add and split into per-head q, k, v run through
  `qkv_heads_fused` (csrc/qkv_heads.cu on the card, the same adds), and
  the attention kernels write their contexts token-major, so `merge_heads`
  of a kernel's context is a view;
- QuickGELU is x * sigmoid(1.702 x) in the activation type, written as
  JAX lowers it: 1.702 rounded to that type first (a weak-typed Python
  scalar), and the sigmoid as 1 / (1 + exp(-z)) with each op rounded
  (`torch.sigmoid` rounds once, and `1.702 * x` keeps the constant in fp32;
  each moved about a quarter of the bf16 results by an ulp);
- exact GELU (OpenCLIP's towers, `activation="gelu"`; the JAX package has
  none) is 0.5 x (1 + erf(x / sqrt 2)) formed in fp32 from the activation
  and rounded once to its type (`F.gelu`'s own rounding point for bf16
  input on the CPU and the card); SigLIP's tanh GELU (`"gelu_tanh"`)
  is `F.gelu(x, approximate="tanh")`, formed and rounded alike;
- the encoder MLP's fc bias add and activation run through `fc_act_fused`
  (csrc/fc_act.cu on the card, the same ops and roundings); the LVC head's
  decoder keeps `mlp`, which autograd records;
- EVA-02's towers (none in the JAX package) add three parts, each formed
  in fp32 from the activation type and rounded once to it, as PyTorch's
  own ops round them: the 2D rotation of q and k at the patch tokens
  (`rope_table`, `apply_rope`; in the card's qkv head split), the
  sub-LayerNorm `ln_inner` on each attention context, and the SwiGLU MLP
  (`swiglu`: silu(a) rounded, times b, rounded, then a LayerNorm over the
  hidden width; csrc/swiglu_gate.cu on the card);
- standard attention returns the head-MEAN of its softmax weights (torch
  nn.MultiheadAttention need_weights semantics), while the surgery attention
  returns the head-SUM of its original-path weights; SVC consumes a mix of
  both, so the distinction matters.

Parameters are the torch-layout tree of models/params.py: linear weights
[out, in], applied as x @ w^T + b.
"""
from __future__ import annotations

import functools

import torch

from .. import build
from ..parallel.distributed import group_mean
from ..utils import profiling
from .attention_kernels import (_KERNEL_HEAD_DIMS, fused_plain_attention,
                                fused_surgery_attention)


def layer_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    orig = x.dtype
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    out = (x32 - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(orig)


_LN_MAX_VECS = 16     # csrc/layer_norm.cu's kMaxVecs: 16-byte vectors a lane


def _layer_norm_kernel(x: torch.Tensor, y: torch.Tensor | None, p: dict,
                       eps: float):
    """csrc/layer_norm.cu on CUDA tensors: (x + y, or None without y; the
    LayerNorm of that sum, or of x). Raises on what the kernel does not
    take: another device or dtype, a width that is no multiple of the
    16-byte vector (8 bf16, 4 fp32) or above 32 x 16 vectors, inputs that
    are not contiguous or not 16-byte aligned."""
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm kernel: unsupported device {x.device}")
    if x.dtype not in build.SUFFIX:
        raise NotImplementedError(f"{x.dtype} LayerNorm: the kernel takes "
                                  "float32 and bfloat16")
    c = x.shape[-1]
    per_vec = 16 // x.element_size()
    if c < per_vec or c % per_vec or c > 32 * _LN_MAX_VECS * per_vec:
        raise ValueError(f"layer_norm kernel: width {c} is not a multiple "
                         f"of {per_vec} up to {32 * _LN_MAX_VECS * per_vec}")
    for t in (x, y):
        if t is None:
            continue
        if (t.shape != x.shape or t.dtype != x.dtype
                or t.device != x.device):
            raise ValueError("layer_norm kernel: x and y must share one "
                             "shape, dtype and device")
        if not t.is_contiguous():
            raise ValueError("layer_norm kernel: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("layer_norm kernel: inputs must start on a "
                             "16-byte boundary")
    scale, bias = p["scale"].float(), p["bias"].float()
    for t in (scale, bias):
        if (t.shape != (c,) or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"layer_norm kernel: scale and bias must be "
                             f"contiguous [{c}] tensors on {x.device}")
    out = torch.empty_like(x)
    s = None if y is None else torch.empty_like(x)
    build.launch(build.typed("excel_layer_norm", x.dtype), x, x.data_ptr(),
                 None if y is None else y.data_ptr(),
                 None if s is None else s.data_ptr(), out.data_ptr(),
                 scale.data_ptr(), bias.data_ptr(), x.numel() // c, c, eps)
    return s, out


def layer_norm_fused(x: torch.Tensor, p: dict,
                     eps: float = 1e-5) -> torch.Tensor:
    """`layer_norm` as the encoder runs it: on a CPU tensor `layer_norm`
    itself, on a CUDA tensor one launch of csrc/layer_norm.cu (its plain
    form) or a raise."""
    if x.device.type == "cpu":
        return layer_norm(x, p, eps)
    return _layer_norm_kernel(x, None, p, eps)[1]


def add_layer_norm_fused(x: torch.Tensor, y: torch.Tensor, p: dict,
                         eps: float = 1e-5):
    """The encoder's residual add and the LayerNorm after it: (s, out) with
    s = x + y in x's type and out = layer_norm(s, p). On CPU tensors
    exactly those two steps; on CUDA tensors one launch of
    csrc/layer_norm.cu (its residual form), which writes both, or a
    raise."""
    if x.device.type == "cpu":
        s = x + y
        return s, layer_norm(s, p, eps)
    return _layer_norm_kernel(x, y, p, eps)


# 1.702 rounded to each activation type on the host: a Python float that
# the product takes as is (a device tensor would cost a blocking copy)
_GELU_ALPHA = {dt: float(torch.tensor(1.702, dtype=dt))
               for dt in (torch.float32, torch.bfloat16)}


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * (1.0 / (1.0 + torch.exp(-(_GELU_ALPHA[x.dtype] * x))))


def gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": gelu, "gelu_tanh": gelu_tanh}


def _product(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x @ w^T with w cast to x's type: `linear` before its bias."""
    return torch.matmul(x, p["w"].to(x.dtype).t())


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    out = _product(x, p)
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


def mlp(x: torch.Tensor, p: dict, act: str = "quick_gelu") -> torch.Tensor:
    """fc, the activation named by `act` (`ACTIVATIONS`), proj."""
    return linear(ACTIVATIONS[act](linear(x, p["fc"])), p["proj"])


# csrc/fc_act.cu's code of each activation
_FC_ACT_CODE = {"quick_gelu": 0, "gelu": 1, "gelu_tanh": 2}


def fc_act_fused(u: torch.Tensor, bias: torch.Tensor,
                 act: str) -> torch.Tensor:
    """The fc bias add and the activation `act` on the fc product u
    [..., hidden] (`_product`), as the encoder's MLP runs them: on a CPU
    tensor `ACTIVATIONS[act](u + bias)` with the bias in u's type (`mlp`'s
    own steps), on a CUDA tensor one launch of csrc/fc_act.cu (the same
    bits), or a raise: another device or dtype, an unknown act, a tensor
    that is not contiguous or not 16-byte aligned, a hidden that is no
    whole number of 16-byte vectors, a bias of another shape, or an input
    that autograd records (the kernel has no backward)."""
    if act not in _FC_ACT_CODE:
        raise ValueError(f"fc_act: activation {act!r}; it takes "
                         f"{', '.join(_FC_ACT_CODE)}")
    if u.device.type == "cpu":
        return ACTIVATIONS[act](u + bias.to(u.dtype))
    if u.device.type != "cuda":
        raise ValueError(f"fc_act kernel: unsupported device {u.device}")
    if u.dtype not in build.SUFFIX:
        raise NotImplementedError(f"{u.dtype} fc_act: the kernel takes "
                                  "float32 and bfloat16")
    bias = bias.to(u.dtype)
    if torch.is_grad_enabled() and (u.requires_grad or bias.requires_grad):
        raise ValueError("fc_act kernel: no backward; run it under "
                         "torch.no_grad()")
    hidden = u.shape[-1]
    if (not u.is_contiguous() or bias.shape != (hidden,)
            or bias.device != u.device or not bias.is_contiguous()):
        raise ValueError(f"fc_act kernel: a contiguous [..., {hidden}] "
                         f"product and a contiguous [{hidden}] bias on "
                         f"{u.device}, got {tuple(u.shape)} and "
                         f"{tuple(bias.shape)}")
    out = torch.empty_like(u)
    if (hidden * u.element_size() % 16
            or any(t.data_ptr() % 16 for t in (u, bias, out))):
        raise ValueError(f"fc_act kernel: 16-byte rows and pointers only, "
                         f"got a hidden of {hidden} {u.dtype} elements")
    build.launch(build.typed("excel_fc_act", u.dtype), u, u.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), u.numel() // hidden,
                 hidden, _FC_ACT_CODE[act])
    return out


def swiglu_gate(u: torch.Tensor, bias: torch.Tensor, ln: dict,
                eps: float = 1e-6) -> torch.Tensor:
    """EVA-02's gate and sub-LayerNorm between the SwiGLU's products, in
    plain PyTorch: u [..., 2 hp] is the W1|W2 product before its bias
    [2 hp] (a in columns [0, h), b in [hp, hp + h), h = len(ln's scale);
    hp > h where the hidden is padded with zero weights). Returns
    LayerNorm(silu(a + b1) * (b + b2)) [..., hp], zero beyond column h;
    the bias add, silu and the product each rounded to u's type."""
    hp = u.shape[-1] // 2
    h = ln["scale"].shape[0]
    z = u + bias.to(u.dtype)
    out = layer_norm(torch.nn.functional.silu(z[..., :h]) * z[..., hp:hp + h],
                     ln, eps)
    return torch.nn.functional.pad(out, (0, hp - h)) if hp > h else out


# csrc/swiglu_gate.cu's largest padded hidden width (a block a row, 32
# bf16 or 16 fp32 elements a thread)
_GATE_MAX_HIDDEN = 4096


def swiglu_gate_fused(u: torch.Tensor, bias: torch.Tensor, ln: dict,
                      eps: float = 1e-6) -> torch.Tensor:
    """`swiglu_gate` as the encoder runs it: on a CPU tensor itself, on a
    CUDA tensor one launch of csrc/swiglu_gate.cu, or a raise: another
    device or dtype, a padded hidden hp that is no whole number of 16-byte
    vectors (models/params.pad_swiglu pads it) or above 4,096, a tensor
    that is not contiguous or not 16-byte aligned."""
    if u.device.type == "cpu":
        return swiglu_gate(u, bias, ln, eps)
    if u.device.type != "cuda":
        raise ValueError(f"swiglu_gate kernel: unsupported device {u.device}")
    if u.dtype not in build.SUFFIX:
        raise NotImplementedError(f"{u.dtype} SwiGLU gate: the kernel takes "
                                  "float32 and bfloat16")
    hp = u.shape[-1] // 2
    h = ln["scale"].shape[0]
    bias = bias.to(u.dtype)
    scale, shift = ln["scale"].float(), ln["bias"].float()
    if (u.shape[-1] != 2 * hp or not 1 <= h <= hp
            or hp > _GATE_MAX_HIDDEN or not u.is_contiguous()):
        raise ValueError(f"swiglu_gate kernel: a contiguous [..., 2 hp] "
                         f"product with h <= hp <= {_GATE_MAX_HIDDEN}, got "
                         f"{tuple(u.shape)} and h = {h}")
    for t, n in ((bias, 2 * hp), (scale, h), (shift, h)):
        if t.shape != (n,) or t.device != u.device or not t.is_contiguous():
            raise ValueError(f"swiglu_gate kernel: the bias and the "
                             f"LayerNorm's must be contiguous [{n}] tensors "
                             f"on {u.device}")
    out = u.new_empty(u.shape[:-1] + (hp,))
    if (hp * u.element_size() % 16
            or any(t.data_ptr() % 16 for t in (u, bias, out))):
        raise ValueError(f"swiglu_gate kernel: 16-byte rows and pointers "
                         f"only, got a hidden of {hp} {u.dtype} elements "
                         f"(models/params.pad_swiglu pads it)")
    build.launch(build.typed("excel_swiglu_gate", u.dtype), u, u.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), scale.data_ptr(),
                 shift.data_ptr(), u.numel() // (2 * hp), h, hp, eps)
    return out


def swiglu(x: torch.Tensor, p: dict, eps: float = 1e-6) -> torch.Tensor:
    """EVA-02's SwiGLU MLP with its sub-LayerNorm: the W1|W2 product
    (p["fc"]: one [2 hp, C] weight), the gate and LayerNorm ln_ffn
    (`swiglu_gate_fused`), W3 (p["proj"], [C, hp])."""
    return linear(swiglu_gate_fused(_product(x, p["fc"]), p["fc"]["b"],
                                    p["ln_ffn"], eps), p["proj"])


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, N, C] -> contiguous [B, heads, N, C//heads]."""
    b, n, c = x.shape
    return x.reshape(b, n, heads, c // heads).permute(0, 2, 1, 3).contiguous()


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, heads, N, D] -> [B, N, heads*D]: a view where x is a permuted
    view of a contiguous [B, N, heads, D] (the attention kernels'
    contexts), else a copy."""
    b, h, n, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, n, h * d)


@functools.lru_cache(maxsize=16)
def rope_table(rope_grid: int, gh: int, gw: int, head_dim: int,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """EVA-02's 2D rotary table (EVA-CLIP's VisionRotaryEmbeddingFast with
    intp_freq) for a gh x gw patch grid: fp32 [2, gh gw, head_dim], cos
    then sin of each patch token's angles, built once a grid and device.
    Dims [0, D/2) turn with the token's row r, [D/2, D) with its column c;
    pair i of a half (dims 2i, 2i + 1) at the angle
    (r / gh) rope_grid 10000^(-2i / (D/2)) (c and gw for the second half),
    formed in fp32 as EVA-CLIP forms it."""
    half = head_dim // 2
    if head_dim % 4:
        raise ValueError(f"rotary head dim {head_dim}: no multiple of 4")
    freqs = 1.0 / (10000 ** (torch.arange(0, half, 2).float() / half))

    def angles(g):
        t = torch.arange(g) / g * rope_grid
        return (t[:, None] * freqs[None]).repeat_interleave(2, dim=-1)

    rows, cols = angles(gh), angles(gw)                 # [g, D/2]
    ang = torch.cat([rows[:, None].expand(gh, gw, half),
                     cols[None].expand(gh, gw, half)], dim=-1)
    ang = ang.reshape(gh * gw, head_dim)
    return torch.stack([ang.cos(), ang.sin()]).to(device)


def _rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1) -> (-x1, x0) over adjacent dims (EVA-CLIP's rotate_half)."""
    x = x.unflatten(-1, (-1, 2))
    return torch.stack((-x[..., 1], x[..., 0]), dim=-1).flatten(-2)


def apply_rope(t: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
    """t [B, H, N, D] with tokens 1..N-1 turned by the table rope [2, N-1,
    D] (`rope_table`) and the CLS token as it is: t cos + rot(t) sin
    formed in fp32, each op rounded as PyTorch rounds it, then once to
    t's type."""
    body = t[:, :, 1:].float()
    body = body * rope[0] + _rotate_pairs(body) * rope[1]
    return torch.cat([t[:, :, :1], body.to(t.dtype)], dim=2)


def qkv_projection(y: torch.Tensor, p: dict, heads: int,
                   rope: torch.Tensor | None = None):
    """Fused qkv projection -> per-head q, k, v ([B, H, N, D] each); with
    a rotary table, q and k turned at the patch tokens (`apply_rope`)."""
    q, k, v = linear(y, p["qkv"]).chunk(3, dim=-1)
    q, k, v = (split_heads(q, heads), split_heads(k, heads),
               split_heads(v, heads))
    if rope is not None:
        q, k = apply_rope(q, rope), apply_rope(k, rope)
    return q, k, v


def qkv_heads_fused(y: torch.Tensor, p: dict, heads: int,
                    rope: torch.Tensor | None = None):
    """`qkv_projection` as the encoder runs it. On a CPU tensor
    `qkv_projection` itself; on a CUDA tensor the same qkv product, then
    `qkv_heads_kernel`."""
    if y.device.type == "cpu":
        return qkv_projection(y, p, heads, rope)
    if y.device.type != "cuda":
        raise ValueError(f"qkv_heads kernel: unsupported device {y.device}")
    if y.dtype not in build.SUFFIX:
        raise NotImplementedError(f"{y.dtype} qkv heads: the kernel takes "
                                  "float32 and bfloat16")
    return qkv_heads_kernel(_product(y, p["qkv"]), p["qkv"]["b"].to(y.dtype),
                            heads, rope)


def qkv_heads_kernel(x: torch.Tensor, bias: torch.Tensor, heads: int,
                     rope: torch.Tensor | None = None):
    """One launch of csrc/qkv_heads.cu on the qkv product x [B, N, 3C] of
    a CUDA tensor: the bias added in x's type and q, k, v written as the
    three contiguous [B, H, N, D] slices of one [3, B, H, N, D] buffer
    (`qkv_projection`'s bits); with a rotary table [2, N-1, D] q and k
    turned at the patch tokens in the same pass (`apply_rope`'s bits).
    Raises on a head dim the kernel does not take or a table of another
    shape."""
    b, n, c3 = x.shape
    d = c3 // (3 * heads)
    if d not in _KERNEL_HEAD_DIMS or c3 != 3 * heads * d:
        raise ValueError(f"qkv_heads kernel: {c3 // 3} channels in {heads} "
                         f"heads; it takes the attention kernels' head dims "
                         f"{_KERNEL_HEAD_DIMS}")
    if bias.shape != (c3,) or not bias.is_contiguous():
        raise ValueError(f"qkv_heads kernel: the bias must be a contiguous "
                         f"[{c3}] tensor")
    out = x.new_empty((3, b, heads, n, d))
    if rope is None:
        build.launch(build.typed("excel_qkv_heads", x.dtype), x,
                     x.data_ptr(), bias.data_ptr(), out.data_ptr(), b, n,
                     heads, d)
        return out[0], out[1], out[2]
    if (rope.shape != (2, n - 1, d) or rope.dtype != torch.float32
            or rope.device != x.device or not rope.is_contiguous()):
        raise ValueError(f"qkv_heads kernel: the rotary table must be a "
                         f"contiguous float32 [2, {n - 1}, {d}] tensor on "
                         f"{x.device}, got {tuple(rope.shape)} {rope.dtype}")
    build.launch(build.typed("excel_qkv_heads_rope", x.dtype), x,
                 x.data_ptr(), bias.data_ptr(), rope.data_ptr(),
                 out.data_ptr(), b, n, heads, d)
    return out[0], out[1], out[2]


def _cpu_only(y: torch.Tensor, name: str) -> None:
    if y.device.type != "cpu":
        raise ValueError(f"{name} is the per-head plain version for CPU "
                         f"tensors; on {y.device} use {name}_fused")


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor | None = None):
    """softmax(q k^T D^-1/2 + mask) v per head in plain PyTorch, on any
    device and differentiable, q [..., Q, D] against k, v [..., N, D]
    (broadcast over the leading dims). The JAX package's type points for
    bf16 input: q * scale in the activation type, the logits formed in
    fp32 (bf16 products are exact there) plus the mask, the softmax in
    fp32, the weights rounded to v's type for the context, which is
    accumulated in fp32 and rounded. Returns (context [..., Q, D] in v's
    type, fp32 weights [..., Q, N])."""
    scale = float(torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype))
    logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if mask is not None:
        logits = logits + mask
    weights = torch.softmax(logits, dim=-1)
    ctx = torch.matmul(weights.to(v.dtype).float(), v.float()).to(v.dtype)
    return ctx, weights


def multi_head_attention(y: torch.Tensor, p: dict, heads: int,
                         mask: torch.Tensor | None = None):
    """Standard multi-head self-attention over pre-normed input in plain
    PyTorch ops (`attend`), on any device and differentiable: the JAX
    package's plain `attention`, which it runs outside any Pallas kernel
    for the LVC head's decoder and, with a causal `mask` [N, N] (fp32,
    added to the logits), for the text tower. Returns (output [B, N, C],
    head-mean fp32 weights [B, N, N])."""
    q, k, v = qkv_projection(y, p, heads)
    ctx, weights = attend(q, k, v, mask)
    return linear(merge_heads(ctx), p["out"]), weights.mean(dim=1)


def attention(y: torch.Tensor, p: dict, heads: int):
    """`multi_head_attention` as the encoder's per-head plain version, for
    CPU tensors only (the encoder calls `attention_fused`)."""
    _cpu_only(y, "attention")
    return multi_head_attention(y, p, heads)


def context_out(ctx: torch.Tensor, p: dict,
                eps: float = 1e-5) -> torch.Tensor:
    """An attention context [B, H, N, D] merged to [B, N, C] and
    projected by p["out"]; where p holds EVA-02's sub-LayerNorm
    "ln_inner", that LayerNorm (at eps) between the two."""
    x = merge_heads(ctx)
    if "ln_inner" in p:
        x = layer_norm_fused(x.contiguous(), p["ln_inner"], eps)
    return linear(x, p["out"])


def surgery_attention(y: torch.Tensor, p: dict, heads: int,
                      ex_attn: torch.Tensor | None = None,
                      rope: torch.Tensor | None = None,
                      eps: float = 1e-5):
    """ExCEL dual-path attention per head in plain PyTorch: the original
    q k^T path and the dense value-value path (mean of softmax(q q^T),
    softmax(k k^T), softmax(v v^T)), optionally calibrated by the LVC
    feature affinity ex_attn [B, M, M] added to every head's patch-patch
    block (the last M rows and columns: after the CLS token where the
    layout has one), then summed over heads so every head aggregates v
    with one shared matrix. For CPU tensors only (the encoder calls
    `surgery_attention_fused`). rope: EVA-02's rotated q, k
    (`qkv_projection`); eps: its sub-LayerNorm's on both contexts
    (`context_out`).

    Returns (dense_out, ori_out, head-summed original weights [B, N, N])."""
    _cpu_only(y, "surgery_attention")
    q, k, v = qkv_projection(y, p, heads, rope)
    scale = q.shape[-1] ** -0.5

    def self_sim(t):
        return torch.softmax(torch.matmul(t * scale, t.transpose(-1, -2)),
                             dim=-1)

    attn_ori = torch.softmax(torch.matmul(q * scale, k.transpose(-1, -2)),
                             dim=-1)
    attn = (self_sim(q) + self_sim(k) + self_sim(v)) / 3.0
    if ex_attn is not None:
        s = attn.shape[-1] - ex_attn.shape[-1]
        attn = attn.clone()
        attn[:, :, s:, s:] += ex_attn[:, None].to(attn.dtype)
    shared = attn.sum(dim=1, keepdim=True)                 # [B,1,N,N]
    ctx_dense = torch.matmul(shared, v)
    ctx_ori = torch.matmul(attn_ori, v)
    dense_out = context_out(ctx_dense, p, eps)
    ori_out = context_out(ctx_ori, p, eps)
    return dense_out, ori_out, attn_ori.sum(dim=1)


def attention_fused(y: torch.Tensor, p: dict, heads: int,
                    attn_acc: torch.Tensor | None = None,
                    need_weights: bool = True,
                    rope: torch.Tensor | None = None,
                    eps: float = 1e-5):
    """`attention` (no mask) through the plain attention kernel. attn_acc:
    optional [B, N, N] fp32 accumulator the kernel adds its head-mean onto
    in place; need_weights=False skips the weights output. rope: EVA-02's
    rotary table [2, N-1, D] (`rope_table`), q and k turned in the head
    split; eps: that of its sub-LayerNorm on the context, where p holds
    one (`context_out`)."""
    with profiling.span("attn"):
        q, k, v = qkv_heads_fused(y, p, heads, rope)
        ctx, w = fused_plain_attention(q, k, v, acc=attn_acc,
                                       need_weights=need_weights)
        return context_out(ctx, p, eps), w


def surgery_attention_fused(y: torch.Tensor, p: dict, heads: int,
                            ex_attn: torch.Tensor | None = None,
                            attn_acc: torch.Tensor | None = None,
                            need_attn: bool = True,
                            rope: torch.Tensor | None = None,
                            eps: float = 1e-5):
    """`surgery_attention` through the surgery attention kernel; attn_acc /
    need_attn control the head-summed original weights, and rope / eps
    EVA-02's parts, as in `attention_fused`. ex_attn [B, M, M]
    (in the activation type) reaches the kernel as fp32 [B, N, N], with a
    zero CLS row and column where the layout has a CLS token (N = M + 1),
    which adds it to the patch-patch block only.
    The dense context shared @ v is one product outside the kernel."""
    with profiling.span("attn"):
        q, k, v = qkv_heads_fused(y, p, heads, rope)
        ex = None
        if ex_attn is not None:
            s = y.shape[1] - ex_attn.shape[-1]
            ex = torch.nn.functional.pad(ex_attn.float(), (s, 0, s, 0))
        shared, attn_sum, ctx_ori = fused_surgery_attention(
            q, k, v, ex_attn=ex, acc=attn_acc, need_attn=need_attn)
        ctx_dense = torch.matmul(shared[:, None].to(v.dtype), v)
        dense_out = context_out(ctx_dense, p, eps)
        ori_out = context_out(ctx_ori, p, eps)
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
