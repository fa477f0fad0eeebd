"""EVA-02's layers' operations and bytes, counted from their shapes
(harness/flops.py's rules: each input read once, each output written
once, no intermediate), and the before-hooks that add each traced call's
least time to a run's work counts for `swiglu_roofline.*`,
`swiglu_gate_roofline.*` and `qkv_rope_roofline.*`. The hidden width is
the published one (ln_ffn's, 2,730), never a padding of it."""
from __future__ import annotations

from . import peaks

FP32 = 4


def swiglu_layer(b: int, n: int, c: int, h: int, act_bytes: int,
                 weight_bytes: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one call of a block's SwiGLU MLP (models/layers.
    swiglu: W1 and W2, the gate and ln_ffn, W3) on [b, n, c] tokens at
    hidden width h: 6 n c h FLOPs an image (16 n c^2 at h = 8 c / 3).
    Bytes: the input and the output once; W1, W2, W3 and their biases
    once; ln_ffn's fp32 scale and shift once."""
    flops = 6.0 * b * n * c * h
    nbytes = 2.0 * b * n * c * act_bytes \
        + (3.0 * c * h + 2.0 * h + c) * weight_bytes + 2.0 * h * FP32
    return flops, nbytes


def swiglu_gate_bytes(tokens: int, h: int, act_bytes: int) -> float:
    """Bytes of one call of the gate and sub-LayerNorm between the
    SwiGLU's products (models/layers.swiglu_gate_fused): a token's 2 h
    product read and its h outputs written, the two biases and ln_ffn's
    fp32 scale and shift once. It multiplies nothing: bound by bytes."""
    return 3.0 * tokens * h * act_bytes + 2.0 * h * act_bytes \
        + 2.0 * h * FP32


def qkv_rope_bytes(b: int, n: int, c: int, head_dim: int,
                   act_bytes: int) -> float:
    """Bytes of one call of the rotating head split (models/layers.
    qkv_heads_kernel with a rotary table): the qkv product [b, n, 3 c] and
    its bias read, the fp32 table [2, n - 1, head_dim] read once, q, k and
    v written ([3, b, H, n, D]). Bound by bytes."""
    return 6.0 * b * n * c * act_bytes + 3.0 * c * act_bytes \
        + 2.0 * (n - 1) * head_dim * FP32


def _bound(f: float, nbytes: float, dtype: str) -> float:
    return peaks.bound_s(f, nbytes, peaks.matmul_peak(dtype))[0]


def _hook(ctx, work, key, count):
    """A before-hook adding count(args, kwargs, dtype) seconds (or
    nothing, where it returns None) to work[key] while the trace runs."""
    dtype = str(ctx.cfg.clip.compute_dtype).split(".")[-1]
    work.setdefault(key, 0.0)

    def before(args, kwargs):
        if not ctx.spans.tracing:
            return
        t = count(args, kwargs, dtype)
        if t is not None:
            work[key] += t
    return before


def swiglu_work(ctx, work):
    """Before-hook of the wrapper around models/clip.swiglu(x, p, eps)."""
    def count(args, kwargs, dtype):
        x, p = args[0], args[1]
        b, n, c = x.shape
        f, nb = swiglu_layer(b, n, c, p["ln_ffn"]["scale"].shape[0],
                             x.element_size(), p["fc"]["w"].element_size())
        return _bound(f, nb, dtype)
    return _hook(ctx, work, "swiglu_bound_s", count)


def swiglu_gate_work(ctx, work):
    """Before-hook of the wrapper around models/layers.swiglu_gate_fused(
    u, bias, ln, eps)."""
    def count(args, kwargs, dtype):
        u, ln = args[0], args[2]
        nb = swiglu_gate_bytes(u.numel() // u.shape[-1],
                               ln["scale"].shape[0], u.element_size())
        return _bound(0.0, nb, dtype)
    return _hook(ctx, work, "swiglu_gate_bound_s", count)


def qkv_rope_work(ctx, work):
    """Before-hook of the wrapper around models/layers.qkv_heads_kernel(
    x, bias, heads, rope): the calls that turn q and k."""
    def count(args, kwargs, dtype):
        rope = args[3] if len(args) > 3 else kwargs.get("rope")
        if rope is None:
            return None
        x, heads = args[0], args[2]
        b, n, c3 = x.shape
        nb = qkv_rope_bytes(b, n, c3 // 3, c3 // (3 * heads),
                            x.element_size())
        return _bound(0.0, nb, dtype)
    return _hook(ctx, work, "qkv_rope_bound_s", count)
