"""The port's convolutional mean-field CRF (excel_tpu_torch.ops.crf_tpu)
against the JAX package's, on the same numpy inputs: the JAX function both
through its XLA message loop (`use_pallas=False`) and through its Pallas
diffusion kernel in interpret mode; the port takes the plain version of its
diffusion kernel (CPU tensors).

Tolerance on Q: 1e-5, the bound of the JAX package's own Pallas-vs-XLA test
(tests/test_crf_tpu.py). The two sides sum the messages' fp32 terms in other
orders (offset order, or chunks of 8) and the update multiplies messages by
bi_w = 4 inside a softmax; observed 1e-6 at most. The canvas height is a
multiple of 8, which the Pallas kernel's row tiles need."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from excel_tpu.config import CrfConfig as JaxCrfConfig
from excel_tpu.ops import crf_tpu as jcrf
from excel_tpu_torch.config import CrfConfig
from excel_tpu_torch.ops import crf_tpu as pcrf
from torch_port_common import n, t

ATOL_Q = 1e-5
B, C, H, W = 2, 5, 48, 64
VALID = np.asarray([[48, 64], [35, 47]], np.int32)   # 35x47: not multiples
#                                                      of the coarse stride


@pytest.fixture(scope="module")
def scene():
    """Two noisy images with a flat left part, peaked random class
    probabilities."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    img[:, :, :30] = img[:, :, :30] // 8 + 100
    probs = rng.random((B, C, H, W), dtype=np.float32) ** 3
    probs /= probs.sum(1, keepdims=True)
    return img, probs


def test_constants_and_ring_helpers_match():
    assert pcrf.DEFAULT_DILATIONS == jcrf.DEFAULT_DILATIONS
    assert pcrf.COARSE_DILATIONS == jcrf.COARSE_DILATIONS
    assert pcrf.COARSE_STRIDE == jcrf.COARSE_STRIDE
    for dil in (jcrf.DEFAULT_DILATIONS, (1, 2, 4), (4, 1, 2)):
        assert pcrf._offsets(dil) == jcrf._offsets(dil)
        assert pcrf._ring_edges(dil) == jcrf._ring_edges(dil)
        assert pcrf._quadrature_weights(dil) == jcrf._quadrature_weights(dil)
        assert pcrf._support_radius(dil) == jcrf._support_radius(dil)
    lo0 = jcrf._support_radius(jcrf.DEFAULT_DILATIONS)
    assert (pcrf._quadrature_weights(pcrf.COARSE_DILATIONS, scale=8.0,
                                     lo0=lo0)
            == jcrf._quadrature_weights(jcrf.COARSE_DILATIONS, scale=8.0,
                                        lo0=lo0))
    assert len(pcrf._offsets(pcrf.DEFAULT_DILATIONS)) == 72


@pytest.mark.parametrize("dy,dx,fill", [(0, 3, 0.0), (-2, 0, 0.0),
                                        (5, -4, 1.5), (-7, -7, 0.0)])
def test_shift_matches(dy, dx, fill):
    x = np.random.default_rng(1).random((2, 3, 9, 11), dtype=np.float32)
    np.testing.assert_array_equal(
        n(pcrf._shift(t(x), dy, dx, fill)),
        np.asarray(jcrf._shift(jnp.asarray(x), dy, dx, fill)))


CASES = {
    "plain": dict(),
    "valid": dict(valid=True),
    "coarse": dict(coarse_stride=8),
    "coarse_valid": dict(coarse_stride=8, valid=True),
    "no_quadrature": dict(quadrature=False),
}


@pytest.mark.parametrize("use_pallas", [False, "interpret"])
@pytest.mark.parametrize("case", list(CASES))
def test_crf_meanfield_matches_jax(scene, case, use_pallas):
    """dilations (1, 2, 4), 2 iterations: Q within 1e-5, rows sum to 1."""
    img, probs = scene
    kw = dict(CASES[case], dilations=(1, 2, 4), iters=2)
    with_valid = kw.pop("valid", False)
    ref = jcrf.crf_meanfield(
        jnp.asarray(img), jnp.asarray(probs), use_pallas=use_pallas,
        valid_hw=jnp.asarray(VALID) if with_valid else None, **kw)
    got = n(pcrf.crf_meanfield(t(img), t(probs),
                               valid_hw=t(VALID) if with_valid else None,
                               **kw))
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL_Q, rtol=0)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)


def test_crf_meanfield_production_support_matches_jax(scene):
    """The default 72 offsets (pad 55, beyond the 48 x 64 canvas in places)
    with valid extents, the coarse level and float images, 3 iterations."""
    img, probs = scene
    kw = dict(iters=3, coarse_stride=pcrf.COARSE_STRIDE)
    ref = jcrf.crf_meanfield(jnp.asarray(img, jnp.float32),
                             jnp.asarray(probs), use_pallas=False,
                             valid_hw=jnp.asarray(VALID), **kw)
    got = pcrf.crf_meanfield(t(img).float(), t(probs), valid_hw=t(VALID),
                             **kw)
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=ATOL_Q, rtol=0)


def test_crf_meanfield_bf16_messages(scene):
    """msg_dtype=bfloat16 (CrfConfig.msg_bf16, the fast preset): Q and the
    pairwise weights in bf16 through the diffusion step's bf16 arithmetic,
    4 iterations. Against the JAX function on its Pallas kernel in
    interpret mode the argmax agrees on >= 99.5% of the pixels (in process
    XLA may skip some bf16 roundings, tests/test_torch_bf16_rounding.py
    holds the step bit for bit; observed 99.93% on these peaked random
    probabilities), and against the port's own fp32 messages likewise (the
    JAX package's bound for bf16 against fp32 messages)."""
    img, probs = scene
    kw = dict(iters=4, dilations=(1, 2, 4))
    ref = jcrf.crf_meanfield(jnp.asarray(img), jnp.asarray(probs),
                             use_pallas="interpret", msg_dtype=jnp.bfloat16,
                             **kw)
    got = pcrf.crf_meanfield(t(img), t(probs), msg_dtype=torch.bfloat16, **kw)
    f32 = pcrf.crf_meanfield(t(img), t(probs), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got).sum(1), 1.0, atol=1e-5)
    assert (n(got).argmax(1) == np.asarray(ref).argmax(1)).mean() >= 0.995
    assert (n(got).argmax(1) == n(f32).argmax(1)).mean() >= 0.995
    # the bf16 route is live: it is not the fp32 result
    assert not torch.equal(got, f32)


@pytest.mark.parametrize("msg_bf16,long_range", [(False, True),
                                                 (False, False),
                                                 (True, True)])
def test_crf_meanfield_cfg_matches_jax(scene, msg_bf16, long_range):
    """The config's parameters, `msg_bf16` and `long_range` reach the
    mean-field as in the JAX package (whose default route on the CPU is the
    XLA loop, in fp32 whatever `msg_bf16` says; the port's bf16 messages
    are held to an argmax bound there)."""
    img, probs = scene
    over = dict(iters=2, bi_xy_std=20.0, bi_rgb_std=5.0, pos_w=2.0,
                msg_bf16=msg_bf16, long_range=long_range)
    ref = np.asarray(jcrf.crf_meanfield_cfg(
        jnp.asarray(img), jnp.asarray(probs), JaxCrfConfig(**over),
        valid_hw=jnp.asarray(VALID), dilations=(1, 2, 4)))
    got = n(pcrf.crf_meanfield_cfg(t(img), t(probs), CrfConfig(**over),
                                   valid_hw=t(VALID), dilations=(1, 2, 4)))
    if msg_bf16:
        assert (got.argmax(1) == ref.argmax(1)).mean() >= 0.995
    else:
        np.testing.assert_allclose(got, ref, atol=ATOL_Q, rtol=0)


def test_crf_meanfield_checks_inputs(scene):
    img, probs = scene
    with pytest.raises(NotImplementedError):
        pcrf.crf_meanfield(t(img), t(probs), msg_dtype=torch.float16)
    with pytest.raises(ValueError, match="annulus"):
        pcrf.crf_meanfield(t(img), t(probs), quadrature=False,
                           coarse_stride=8)
