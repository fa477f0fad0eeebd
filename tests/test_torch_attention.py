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
