"""Port attention (excel_tpu_torch.models.attention_kernels) against the JAX
package's Pallas kernels, run in interpret mode on the CPU; on CPU tensors
the port's wrappers compute their plain versions, which the card holds the
CUDA kernels against."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from excel_tpu.models.attention_pallas import (fused_plain_attention as
                                               jax_plain,
                                               fused_surgery_attention as
                                               jax_surgery)
from excel_tpu_torch.models import attention_kernels as ak
from torch_port_common import n, t

# fp32 softmax rows and their products summed in another order: 1e-5 abs
# on probabilities (and their head sums) and on contexts of unit-variance v
ATOL = 1e-5


def _qkv(seed, b, heads, tokens, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, heads, tokens, d)).astype(np.float32)
            for _ in range(3)]


# N=17: tiny encoder; N=300: not a multiple of 256, so the JAX no-weights
# route is the masked rows_hb kernel
@pytest.mark.parametrize("tokens", [17, 300])
@pytest.mark.parametrize("mode", ["none", "out", "acc"])
def test_plain_attention_matches_pallas(tokens, mode):
    q, k, v = _qkv(tokens, 2, 3, tokens, 32)
    acc = np.random.default_rng(1).random((2, tokens, tokens),
                                          dtype=np.float32)
    kw = dict(need_weights=mode != "none")
    jctx, jw = jax_plain(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         interpret=True,
                         acc=jnp.asarray(acc) if mode == "acc" else None,
                         **kw)
    pctx, pw = ak.fused_plain_attention(
        t(q), t(k), t(v), acc=t(acc) if mode == "acc" else None, **kw)
    np.testing.assert_allclose(n(pctx), np.asarray(jctx), atol=ATOL)
    if mode == "none":
        assert jw is None and pw is None
    else:
        np.testing.assert_allclose(n(pw), np.asarray(jw), atol=ATOL)


@pytest.mark.parametrize("mode", ["none", "out", "acc"])
def test_surgery_attention_matches_pallas(mode):
    q, k, v = _qkv(7, 2, 3, 17, 32)
    acc = np.random.default_rng(2).random((2, 17, 17), dtype=np.float32)
    kw = dict(need_attn=mode != "none")
    js, ja, jc = jax_surgery(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             None, interpret=True,
                             acc=jnp.asarray(acc) if mode == "acc" else None,
                             **kw)
    ps, pa, pc = ak.fused_surgery_attention(
        t(q), t(k), t(v), acc=t(acc) if mode == "acc" else None, **kw)
    np.testing.assert_allclose(n(ps), np.asarray(js), atol=ATOL)
    np.testing.assert_allclose(n(pc), np.asarray(jc), atol=ATOL)
    if mode == "none":
        assert ja is None and pa is None
    else:
        np.testing.assert_allclose(n(pa), np.asarray(ja), atol=ATOL)


def test_surgery_attention_ex_matches_pallas():
    q, k, v = _qkv(8, 1, 2, 17, 32)
    ex = np.random.default_rng(3).random((1, 17, 17), dtype=np.float32)
    js, ja, jc = jax_surgery(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(ex), interpret=True)
    ps, pa, pc = ak.fused_surgery_attention(t(q), t(k), t(v), t(ex))
    for a, b in ((ps, js), (pa, ja), (pc, jc)):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=ATOL)


def test_wrappers_check_inputs():
    q, k, v = (t(x) for x in _qkv(0, 1, 2, 9, 32))
    with pytest.raises(ValueError):
        ak.fused_plain_attention(q, k[:, :1], v)
    with pytest.raises(ValueError):
        ak.fused_plain_attention(q.transpose(2, 3), k.transpose(2, 3),
                                 v.transpose(2, 3))
    with pytest.raises(NotImplementedError):
        ak.fused_surgery_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        ak.fused_plain_attention(q.bfloat16(), k, v)
    with pytest.raises(ValueError):
        ak.fused_surgery_attention(q, k, v, acc=t(np.zeros((1, 9, 8),
                                                           np.float32)))


# bf16 q/k/v, as the fast preset runs them: fp32 logits, softmax and
# weights; P rounded to bf16 before P V; a bf16 context. The weights are
# fp32 sums in another order (1e-6); a context may round to the
# neighbouring bf16 value (one bf16 ulp of contexts below 4: 2^-6)
BF16_CTX_ATOL = 2.0 ** -6
BF16_W_ATOL = 1e-6


def _qkv_bf16(seed, b, heads, tokens, d):
    return [jnp.asarray(x).astype(jnp.bfloat16)
            for x in _qkv(seed, b, heads, tokens, d)]


def _t16(x):
    return t(np.asarray(x.astype(jnp.float32))).bfloat16()


def _close16(got, ref, atol):
    np.testing.assert_allclose(n(got.float()),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("tokens", [17, 300])
@pytest.mark.parametrize("mode", ["none", "out", "acc"])
def test_plain_attention_bf16_matches_pallas(tokens, mode):
    q, k, v = _qkv_bf16(tokens + 1, 2, 3, tokens, 32)
    acc = np.random.default_rng(4).random((2, tokens, tokens),
                                          dtype=np.float32)
    kw = dict(need_weights=mode != "none")
    jctx, jw = jax_plain(q, k, v, interpret=True,
                         acc=jnp.asarray(acc) if mode == "acc" else None,
                         **kw)
    pctx, pw = ak.fused_plain_attention(
        _t16(q), _t16(k), _t16(v), acc=t(acc) if mode == "acc" else None,
        **kw)
    assert pctx.dtype == torch.bfloat16
    _close16(pctx, jctx, BF16_CTX_ATOL)
    if mode == "none":
        assert jw is None and pw is None
    else:
        assert pw.dtype == torch.float32
        _close16(pw, jw, BF16_W_ATOL)


@pytest.mark.parametrize("mode", ["none", "out", "acc"])
def test_surgery_attention_bf16_matches_pallas(mode):
    q, k, v = _qkv_bf16(9, 2, 3, 17, 32)
    acc = np.random.default_rng(5).random((2, 17, 17), dtype=np.float32)
    kw = dict(need_attn=mode != "none")
    js, ja, jc = jax_surgery(q, k, v, None, interpret=True,
                             acc=jnp.asarray(acc) if mode == "acc" else None,
                             **kw)
    ps, pa, pc = ak.fused_surgery_attention(
        _t16(q), _t16(k), _t16(v), acc=t(acc) if mode == "acc" else None,
        **kw)
    assert pc.dtype == torch.bfloat16 and ps.dtype == torch.float32
    _close16(ps, js, BF16_W_ATOL)
    _close16(pc, jc, BF16_CTX_ATOL)
    if mode == "none":
        assert ja is None and pa is None
    else:
        _close16(pa, ja, BF16_W_ATOL)


# ---------------------------------------------------------------------------
# the plain versions at token counts around the CUDA kernels' tile edges
# (16-row fragments, 64-row tiles and 64-key chunks), both types, D=32: the
# yardstick the card holds the kernels to, held to the Pallas kernels here
# ---------------------------------------------------------------------------

def _run_both(kind, dtype, tokens, mode, with_ex=False, d=32, seed=11):
    """(port outputs, JAX outputs) of one case, `None`s dropped."""
    bf16 = dtype == "bf16"
    q, k, v = (_qkv_bf16 if bf16 else _qkv)(seed + tokens, 2, 3, tokens, d)
    rng = np.random.default_rng(seed)
    acc = rng.random((2, tokens, tokens), dtype=np.float32)
    ex = (rng.random((2, tokens, tokens), dtype=np.float32) / tokens
          if with_ex else None)
    to_t = _t16 if bf16 else t
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jacc = jnp.asarray(acc) if mode == "acc" else None
    tacc = t(acc) if mode == "acc" else None
    if kind == "plain":
        kw = dict(need_weights=mode != "none")
        ref = jax_plain(jq, jk, jv, interpret=True, acc=jacc, **kw)
        got = ak.fused_plain_attention(to_t(q), to_t(k), to_t(v), acc=tacc,
                                       **kw)
    else:
        kw = dict(need_attn=mode != "none")
        ref = jax_surgery(jq, jk, jv, None if ex is None else jnp.asarray(ex),
                          interpret=True, acc=jacc, **kw)
        got = ak.fused_surgery_attention(
            to_t(q), to_t(k), to_t(v), None if ex is None else t(ex),
            acc=tacc, **kw)
    assert [g is None for g in got] == [r is None for r in ref]
    return ([g for g in got if g is not None],
            [r for r in ref if r is not None])


@pytest.mark.parametrize("tokens", [15, 65, 129])
@pytest.mark.parametrize("mode", ["none", "out", "acc"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["plain", "surgery"])
def test_tile_edge_tokens_match_pallas(kind, dtype, mode, tokens):
    got, ref = _run_both(kind, dtype, tokens, mode,
                         with_ex=kind == "surgery" and mode == "out")
    for g, r in zip(got, ref):
        if g.dtype == torch.bfloat16:
            _close16(g, r, BF16_CTX_ATOL)
        elif dtype == "bf16":
            # head sums of up to 3 probabilities (+ ex): fp32 sums in
            # another order
            _close16(g, r, 3 * BF16_W_ATOL)
        else:
            np.testing.assert_allclose(n(g), np.asarray(r), atol=ATOL)


# ---------------------------------------------------------------------------
# what the wrappers gained in Python: the scratch between the two kernels
# of an entry point, the rounding allowance the card checks use, and the
# ctypes signatures of every C entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,mode,expect", [
    ("plain", "none", None), ("plain", "out", (2, 12, 401, 2)),
    ("plain", "acc", (2, 12, 401, 2)), ("surgery", "none", (2, 12, 401, 8)),
    ("surgery", "out", (2, 12, 401, 8)), ("surgery", "acc", (2, 12, 401, 8))])
def test_stats_shape(kind, mode, expect):
    assert ak.stats_shape(kind, mode, 2, 12, 401) == expect


def test_stats_shape_rejects_unknown():
    with pytest.raises(ValueError):
        ak.stats_shape("dense", "out", 1, 1, 1)
    with pytest.raises(ValueError):
        ak.stats_shape("plain", "mean", 1, 1, 1)


def test_rounding_allowance_is_zero_for_fp32():
    q, k, v = (t(x) for x in _qkv(3, 1, 2, 33, 32))
    allow = ak.context_rounding_allowance(q, k, v)
    assert allow.shape == q.shape and not allow.any()


@pytest.mark.parametrize("tokens", [17, 65, 300])
def test_rounding_allowance_covers_an_fp32_ulp_of_p(tokens):
    """p moved by 2^-21 of its size (what another exponential and
    reciprocal do) moves the bf16 context by at most one bf16 ulp of its
    own size plus the allowance, which is nonzero only where some p lies
    at a bf16 tie: for few p."""
    q, k, v = (t(x).bfloat16() for x in _qkv(tokens, 2, 3, tokens, 32))
    p = ak._softmax_sim(q, k)
    sign = torch.from_numpy(np.random.default_rng(0).choice(
        [-1.0, 1.0], size=tuple(p.shape)).astype(np.float32))
    moved = p * (1 + sign * 2.0 ** -21)
    ref, got = ak._pv(p, v).float(), ak._pv(moved, v).float()
    allow = ak.context_rounding_allowance(q, k, v)
    lim = 2.0 ** -7 * ref.abs() + 2.0 ** -20 * float(v.float().abs().max())
    assert bool(((got - ref).abs() <= lim + allow).all())
    # the ties themselves: p within 2^-20 of a midpoint, about 1 in 1,000
    flipped = (moved.bfloat16() != p.bfloat16()).float().mean()
    assert float(flipped) < 0.01 and (tokens < 65 or float(flipped) > 0)
    assert float((allow > 0).float().mean()) < 0.5


def _c_signatures():
    """{entry point: ctypes argument types} parsed from the extern "C"
    declarations of csrc/*.cu."""
    import ctypes
    import glob
    import os
    import re

    from excel_tpu_torch import build

    sigs = {}
    for path in glob.glob(os.path.join(build.CSRC, "*.cu")):
        with open(path) as f:
            src = f.read()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', src):
            types = []
            for prm in params.split(","):
                prm = " ".join(prm.split())
                types.append(ctypes.c_void_p if "*" in prm else
                             {"int": ctypes.c_int, "float": ctypes.c_float}[
                                 prm.split()[0]])
            sigs[name] = types
    return sigs


def test_bindings_match_the_c_entry_points():
    from excel_tpu_torch import build

    sigs = _c_signatures()
    bound = {sym: args for entries in build.ENTRY_POINTS.values()
             for sym, args in entries.items()}
    assert set(bound) == set(sigs)
    for sym, args in bound.items():
        assert list(args) == sigs[sym], sym


def test_attention_sources_keep_their_contract():
    """bf16 products on the tensor cores, no fp32 staging of bf16 tiles,
    no atomics on outputs, no fast-math flag shared with the other
    sources, and the Pallas functions named."""
    import os

    from excel_tpu_torch import build

    def read(name):
        with open(os.path.join(build.CSRC, name)) as f:
            return f.read()

    mma = read("attention_mma.cuh")
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in mma
    assert "ldmatrix" in mma and "cp.async" in read("attention_common.cuh")
    assert "__bfloat162float" not in mma
    for name in ("attention_mma.cuh", "attention_fma.cuh",
                 "attention_common.cuh", "attention_plain.cu",
                 "attention_surgery.cu"):
        code = "\n".join(line.split("//")[0]
                         for line in read(name).splitlines()).lower()
        assert "atomic" not in code and "tf32" not in code, name
    assert "-use_fast_math" not in build.NVCC_FLAGS
    assert "_plain_kernel_rows_hb" in read("attention_plain.cu")
    assert "_kernel_rows" in read("attention_surgery.cu")
