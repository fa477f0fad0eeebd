"""Fused attention for the encoder: CUDA kernels and their plain versions.

Counterpart of excel_tpu/models/attention_pallas.py. Two wrappers:

- `fused_plain_attention` runs csrc/attention_plain.cu, which replaces the
  Pallas `_plain_kernel` and `_plain_kernel_rows_hb`;
- `fused_surgery_attention` runs csrc/attention_surgery.cu, which replaces
  the Pallas `_kernel` and computes what `_kernel_rows` computes.

Both take fp32 or bf16 q/k/v (one C entry point each) and run two kernels
an entry point (csrc/attention_common.cuh): a rows kernel (the exact
softmax in two passes over the keys with the logits formed twice, P V, and
each row's softmax statistics into a small scratch) and a sums kernel (the
[N, N] head sums, a 64 x 64 patch a block, every head's terms added in
registers and written once). The bf16 entry points multiply on the tensor
cores (`mma.sync`, csrc/attention_mma.cuh) and are bound by the softmaxes'
exponentials and L2 reads; the fp32 ones stay exact fp32 FMA
(csrc/attention_fma.cuh) and are bound by FMA throughput. With bf16 inputs the
arithmetic is the TPU kernels': fp32 logits, softmax and weight sums, the
normalised P rounded to bf16 before P V, a bf16 context. The weights
output has the TPU kernels' three modes: "out" (own output), "acc" (added
in place onto an accumulator, the cross-block mean of the training-free
path; bit for bit "out" + the accumulator) and "none" (never written); it
is fp32 for either input type. A launch gives the same bits every time.

On a CPU tensor a wrapper computes its plain PyTorch version; on a CUDA
tensor it launches its kernel or raises. Each wrapper counts the calls of
its C entry point (one launch of the rows kernel and of the sums kernels
back to back) in its `launches` attribute, and in `launches_by_row` under the
Pallas function the JAX package would route the same call to: plain
attention without weights at N <= 512 to `_plain_kernel_rows_hb`, every
other plain call to `_plain_kernel`; surgery attention at N <= 640 to
`_kernel`, above to `_kernel_rows`.
"""
from __future__ import annotations

import torch

from .. import build

_MODES = {"none": 0, "out": 1, "acc": 2}
_KERNEL_HEAD_DIMS = (32, 64)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the JAX package's routing thresholds (attention_pallas.py), which
# `launches_by_row` follows; the CUDA kernels take any N
_ROWS_HB_MAX_N = 512
_WHOLE_N_MAX_N = 640


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, H, N, D] shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if q.dtype not in _SUFFIX:
        raise NotImplementedError(f"{q.dtype} attention: the kernels take "
                                  "float32 and bfloat16")
    for t in (q, k, v):
        if t.dtype != q.dtype:
            raise ValueError("q, k, v must share one dtype")
        if t.device != q.device:
            raise ValueError("q, k, v must be on one device")
        if not t.is_contiguous():
            raise ValueError("q, k, v must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.device.type == "cuda":
        if q.shape[-1] not in _KERNEL_HEAD_DIMS:
            raise ValueError(f"the attention kernels take head dims "
                             f"{_KERNEL_HEAD_DIMS}, got {q.shape[-1]}")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("the attention kernels read q, k, v 16 bytes at "
                             "a time: they must start on a 16-byte boundary")


def _check_nn(t: torch.Tensor, q: torch.Tensor, name: str) -> None:
    b, _, n, _ = q.shape
    if (t.shape != (b, n, n) or t.dtype != torch.float32
            or t.device != q.device or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 [B, N, N] = "
                         f"{(b, n, n)} tensor on {q.device}, got "
                         f"{tuple(t.shape)} {t.dtype} {t.device}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def stats_shape(kind: str, mode: str, b: int, heads: int, n: int):
    """Shape of the fp32 scratch an entry point needs, or None.

    An entry point runs two kernels; the first hands the second each row's
    softmax statistics (m c, 1 / s): one pair for plain attention with
    weights, four (q k^T, q q^T, k k^T, v v^T) for surgery attention in
    every mode (`shared` is always formed). Plain attention without weights
    is one kernel and needs none."""
    if kind not in ("plain", "surgery") or mode not in _MODES:
        raise ValueError(f"unknown kernel {kind!r} or mode {mode!r}")
    if kind == "plain" and mode == "none":
        return None
    return (b, heads, n, 2 if kind == "plain" else 8)


def _stats(kind: str, mode: str, q: torch.Tensor):
    b, heads, n, _ = q.shape
    shape = stats_shape(kind, mode, b, heads, n)
    return None if shape is None else q.new_empty(shape, dtype=torch.float32)


# ---------------------------------------------------------------------------
# plain attention
# ---------------------------------------------------------------------------

def _softmax_sim(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """softmax(a c^T D^-1/2) in fp32: the products of bf16 inputs are exact
    in fp32, so this is the fp32-accumulated logit of either type."""
    scale = a.shape[-1] ** -0.5
    return torch.softmax(
        torch.matmul(a.float(), c.float().transpose(-1, -2)) * scale, dim=-1)


def _pv(attn: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """attn v with attn rounded to v's type first, accumulated in fp32 and
    returned in v's type."""
    return torch.matmul(attn.to(v.dtype).float(), v.float()).to(v.dtype)


def context_rounding_allowance(q, k, v, rel: float = 2.0 ** -20):
    """How far a kernel's context may lie from the plain version's because
    the normalised p is rounded to v's type before P V: [B, H, N, D] fp32.

    A kernel forms p = exp(x - m) / s with another exponential, reciprocal
    and order of summation than `torch.softmax`, so its fp32 p differs by a
    few fp32 ulps (`rel` of its size bounds that). Where the plain
    version's p lies that close to the midpoint of two bf16 values, the
    kernel's p may round to the other one, and the context row moves by one
    bf16 ulp of that p times |v| of its key. The allowance sums exactly
    those terms, so it is 0 for almost every element (and everywhere for
    fp32, where p is not rounded)."""
    if v.dtype == torch.float32:
        return torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    p = _softmax_sim(q, k)
    _, e = torch.frexp(p)       # p = m 2^e, m in [0.5, 1): bf16 ulp 2^(e-8)
    ulp = torch.ldexp(torch.ones_like(p), e - 8)
    near_tie = (p - p.to(v.dtype).float()).abs() >= 0.5 * ulp - rel * p
    return torch.matmul(torch.where(near_tie, ulp, torch.zeros_like(ulp)),
                        v.float().abs())


def plain_attention_reference(q, k, v, acc=None, need_weights=True):
    """Plain version of `fused_plain_attention`, same arguments and
    results."""
    b, heads, n, d = q.shape
    attn = _softmax_sim(q, k)
    ctx = _pv(attn, v)
    if acc is None and not need_weights:
        return ctx, None
    w = acc if acc is not None else attn.new_zeros((b, n, n))
    for h in range(heads):
        w += attn[:, h] / heads
    return ctx, w


def fused_plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          acc: torch.Tensor | None = None,
                          need_weights: bool = True):
    """softmax(q k^T D^-1/2) v per (image, head) with the head-MEAN weights.

    q/k/v: contiguous [B, H, N, D], all float32 or all bfloat16. Returns
    (ctx [B, H, N, D] in q's type, weights): the fp32 head-mean [B, N, N]
    ("out"), `acc` with the head-mean
    added in place when an accumulator is given ("acc"; the caller must not
    reuse `acc`), or None with need_weights=False ("none")."""
    _check_qkv(q, k, v)
    mode = "acc" if acc is not None else ("out" if need_weights else "none")
    if acc is not None:
        _check_nn(acc, q, "acc")
    if q.device.type == "cpu":
        return plain_attention_reference(q, k, v, acc, need_weights)
    b, heads, n, d = q.shape
    ctx = torch.empty_like(q)
    weights = acc if mode == "acc" else (
        q.new_empty((b, n, n), dtype=torch.float32) if mode == "out"
        else None)
    fn = build.load("attention_plain",
                    f"excel_plain_attention_{_SUFFIX[q.dtype]}")
    stats = _stats("plain", mode, q)
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ctx.data_ptr(),
                   _ptr(weights), _ptr(stats), b, heads, n, d, _MODES[mode],
                   _stream(q)),
                "attention_plain")
    fused_plain_attention.launches += 1
    row = ("_plain_kernel_rows_hb" if mode == "none" and n <= _ROWS_HB_MAX_N
           else "_plain_kernel")
    fused_plain_attention.launches_by_row[row] += 1
    return ctx, weights


fused_plain_attention.launches = 0
fused_plain_attention.launches_by_row = {"_plain_kernel": 0,
                                         "_plain_kernel_rows_hb": 0}


# ---------------------------------------------------------------------------
# surgery attention
# ---------------------------------------------------------------------------

def surgery_attention_reference(q, k, v, ex_attn=None, acc=None,
                                need_attn=True):
    """Plain version of `fused_surgery_attention`, same arguments and
    results."""
    b, heads, n, d = q.shape
    attn_ori = _softmax_sim(q, k)
    mix = (_softmax_sim(q, q) + _softmax_sim(k, k) + _softmax_sim(v, v)) / 3.0
    if ex_attn is not None:
        mix = mix + ex_attn[:, None]
    shared = mix.new_zeros((b, n, n))
    for h in range(heads):
        shared += mix[:, h]
    ctx_ori = _pv(attn_ori, v)
    if acc is None and not need_attn:
        return shared, None, ctx_ori
    attn_sum = acc if acc is not None else mix.new_zeros((b, n, n))
    for h in range(heads):
        attn_sum += attn_ori[:, h]
    return shared, attn_sum, ctx_ori


def fused_surgery_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            ex_attn: torch.Tensor | None = None,
                            acc: torch.Tensor | None = None,
                            need_attn: bool = True):
    """ExCEL dual-path attention per (image, head), reduced over heads.

    q/k/v: contiguous [B, H, N, D], all float32 or all bfloat16; ex_attn:
    optional fp32 [B, N, N] additive calibration (zero over the CLS
    row/column). Returns
    (shared [B, N, N] fp32 — head-sum of the dense mix,
     attn_sum — fp32 head-sum of softmax(q k^T) [B, N, N] ("out"), `acc`
                with it added in place ("acc"), or None with need_attn=False,
     ctx_ori [B, H, N, D] in q's type — softmax(q k^T) v per head)."""
    _check_qkv(q, k, v)
    mode = "acc" if acc is not None else ("out" if need_attn else "none")
    if acc is not None:
        _check_nn(acc, q, "acc")
    if ex_attn is not None:
        _check_nn(ex_attn, q, "ex_attn")
    if q.device.type == "cpu":
        return surgery_attention_reference(q, k, v, ex_attn, acc, need_attn)
    b, heads, n, d = q.shape
    shared = q.new_empty((b, n, n), dtype=torch.float32)
    ctx_ori = torch.empty_like(q)
    attn_sum = acc if mode == "acc" else (
        q.new_empty((b, n, n), dtype=torch.float32) if mode == "out"
        else None)
    fn = build.load("attention_surgery",
                    f"excel_surgery_attention_{_SUFFIX[q.dtype]}")
    stats = _stats("surgery", mode, q)
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ex_attn),
                   shared.data_ptr(), _ptr(attn_sum), ctx_ori.data_ptr(),
                   _ptr(stats), b, heads, n, d, _MODES[mode], _stream(q)),
                "attention_surgery")
    fused_surgery_attention.launches += 1
    fused_surgery_attention.launches_by_row[
        "_kernel" if n <= _WHOLE_N_MAX_N else "_kernel_rows"] += 1
    return shared, attn_sum, ctx_ori


fused_surgery_attention.launches = 0
fused_surgery_attention.launches_by_row = {"_kernel": 0, "_kernel_rows": 0}
