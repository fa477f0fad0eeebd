"""Port PAR (excel_tpu_torch.ops.par) against the JAX package's, with the
JAX diffusion through its Pallas kernel in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from excel_tpu.ops.par import _offsets as jax_offsets
from excel_tpu.ops.par import _replicate_valid as jax_replicate_valid
from excel_tpu.ops.par import par_refine as jax_par_refine
from excel_tpu.ops.par_pallas import pad_for_diffuse, par_diffuse as jax_diffuse
from excel_tpu_torch.ops.par import _offsets, _replicate_valid, par_refine
from excel_tpu_torch.ops.par_kernels import offsets_tensor, par_diffuse
from torch_port_common import n, t

DILATIONS = (1, 2, 4, 8, 12, 24)


def _canvas(seed, b=3, c=4, h=64, w=128):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((b, 3, h, w)).astype(np.float32)
    masks = rng.random((b, c, h, w), dtype=np.float32)
    # mixed extents: a full canvas, a portrait crop, a small corner
    valid = np.asarray([[h, w], [50, 100], [33, 77]][:b], np.int32)
    return img, masks, valid


def test_offsets_and_replicate_valid_match():
    assert _offsets(DILATIONS) == jax_offsets(DILATIONS)
    _, masks, valid = _canvas(0)
    np.testing.assert_array_equal(
        n(_replicate_valid(t(masks), t(valid))),
        np.asarray(jax_replicate_valid(jnp.asarray(masks),
                                       jnp.asarray(valid))))


def test_par_diffuse_step_matches_pallas():
    """One step: the TPU kernel sums its 48 products in chunks of 8, the
    port in offset order; fp32 on values in [0, 1]: 1e-6 abs."""
    img, masks, valid = _canvas(1)
    rng = np.random.default_rng(2)
    k = len(_offsets(DILATIONS))
    aff = rng.random((3, k, 64, 128), dtype=np.float32)
    aff /= aff.sum(axis=1, keepdims=True)
    m = np.asarray(jax_replicate_valid(jnp.asarray(masks),
                                       jnp.asarray(valid)))
    ref = jax_diffuse(pad_for_diffuse(jnp.asarray(m), 24), jnp.asarray(aff),
                      tuple(jax_offsets(DILATIONS)), interpret=True)
    got = par_diffuse(t(m), t(aff), offsets_tensor(_offsets(DILATIONS),
                                                   "cpu"))
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-6)


def test_par_refine_valid_matches_pallas():
    """fp32 par_refine with per-image extents on a 64x128 canvas, the
    production dilations and 20 steps. Tolerance 1e-5: affinity softmax and
    diffusion sums in another order."""
    img, masks, valid = _canvas(3)
    ref = jax_par_refine(jnp.asarray(img), jnp.asarray(masks),
                         dilations=DILATIONS, num_iter=20,
                         valid_hw=jnp.asarray(valid), use_pallas="interpret")
    got = par_refine(t(img), t(masks), dilations=DILATIONS, num_iter=20,
                     valid_hw=t(valid))
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-5)


def test_par_refine_full_extent_matches_jnp():
    img, masks, _ = _canvas(4, b=2, c=3, h=40, w=56)
    ref = jax_par_refine(jnp.asarray(img), jnp.asarray(masks),
                         dilations=(1, 2, 4), num_iter=3, use_pallas=False)
    got = par_refine(t(img), t(masks), dilations=(1, 2, 4), num_iter=3)
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-5)


def test_par_bf16_not_ported():
    """bf16 PAR with a pad that is not a multiple of 8 (the tiny config's
    dilations (1, 2)) has no padded kernel; it takes the per-step route,
    which mirrors the JAX package's Pallas route there (`use_pallas="interpret"`:
    fp32 affinity rounded to bf16, `par_diffuse` with a bf16 output,
    `_replicate_valid` each step), not the XLA loop the JAX package runs
    without Pallas. In process XLA may skip some bf16 roundings the program
    writes down, so the bound is two bf16 ulps of masks in [1, 2) (observed
    one, 2^-6 after 3 steps); tests/test_torch_bf16_rounding.py holds the
    same route bit for bit. Other storage types still raise."""
    img, masks, valid = _canvas(5, b=2, c=3, h=40, w=64)
    for v in (valid, None):
        ref = jax_par_refine(
            jnp.asarray(img), jnp.asarray(masks), dilations=(1, 2),
            num_iter=3, valid_hw=None if v is None else jnp.asarray(v),
            use_pallas="interpret", dtype=jnp.bfloat16)
        got = par_refine(t(img), t(masks), dilations=(1, 2), num_iter=3,
                         valid_hw=None if v is None else t(v),
                         dtype=torch.bfloat16)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(n(got), np.asarray(ref), atol=2.0 ** -5,
                                   rtol=0)
    with pytest.raises(NotImplementedError):
        par_refine(t(img), t(masks), dtype=torch.float16)


# (B, C, h, w): pad 55 beyond the canvas in both directions, odd and
# unaligned widths, 1, 9 and 21 channels (heights multiples of 8, which the
# Pallas kernel needs)
@pytest.mark.parametrize("b,c,h,w", [(2, 21, 40, 64), (1, 1, 8, 61),
                                     (2, 9, 16, 200), (1, 21, 40, 61)])
def test_par_diffuse_crf_offsets_matches_pallas(b, c, h, w):
    """One fp32 step at the mean-field CRF's 72 offsets (pad 55, larger than
    the canvas): the TPU kernel sums in chunks of 8, the port in offset
    order; values in [0, 1]: 1e-6 abs."""
    from excel_tpu.ops.crf_tpu import DEFAULT_DILATIONS as CRF_DILATIONS

    offs = _offsets(CRF_DILATIONS)
    assert len(offs) == 72
    rng = np.random.default_rng(11)
    m = rng.random((b, c, h, w), dtype=np.float32)
    aff = rng.random((b, 72, h, w), dtype=np.float32)
    aff /= aff.sum(axis=1, keepdims=True)
    ref = jax_diffuse(pad_for_diffuse(jnp.asarray(m), 55), jnp.asarray(aff),
                      tuple(offs), interpret=True)
    got = par_diffuse(t(m), t(aff), offsets_tensor(offs, "cpu"))
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-6, rtol=0)


def test_staged_pad_keeps_par_halo_and_cuts_crf_halo():
    """The kernel's staged halo: PAR's 48 offsets stage their whole pad 24
    (one or two channel passes); the CRF's 72 at 21 fp32 channels stage
    less than its pad 55, so the affinities take fewer passes and the outer
    dilations read global memory; bf16 stages the whole pad; the host copy
    of the offsets is found without reading the tensor, and a tensor made
    elsewhere is read."""
    from excel_tpu_torch.ops import par_kernels as pk
    from excel_tpu_torch.ops.crf_tpu import DEFAULT_DILATIONS
    from excel_tpu_torch.ops.crf_tpu import _offsets as crf_offsets

    par = tuple(_offsets(DILATIONS))
    crf = tuple(crf_offsets(DEFAULT_DILATIONS))
    for c in (1, 4, 5, 9):
        for elem in (4, 2):
            assert pk.staged_pad(par, c, elem) == 24
    for elem in (4, 2):
        assert pk.staged_pad(crf, 1, elem) == 55
    assert pk.staged_pad(crf, 21, 4) in (13, 21, 34)
    assert pk.staged_pad(crf, 21, 2) == 55
    t = offsets_tensor(crf, "cpu")
    assert pk._host_offsets(t) == crf
    assert pk._host_offsets(t.clone()) == crf


def test_par_diffuse_checks_types():
    offs = offsets_tensor(_offsets((1, 2)), "cpu")
    m = torch.rand((1, 2, 8, 8))
    aff = torch.rand((1, 16, 8, 8))
    assert par_diffuse(m.bfloat16(), aff.bfloat16(),
                       offs).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="share a dtype"):
        par_diffuse(m.bfloat16(), aff, offs)
    with pytest.raises(NotImplementedError):
        par_diffuse(m.half(), aff.half(), offs)
    with pytest.raises(ValueError):
        par_diffuse(m, aff[:, :8], offs)


# ---------------------------------------------------------------------------
# full extent (training's pseudo-labels): Pallas rows 8 (fp32) and 6 (bf16)
# ---------------------------------------------------------------------------

def test_padded_hcw_step_matches_pallas():
    """Plain row 8 (`par_diffuse_padded_hcw_reference`) against the Pallas
    `_diffuse_hcw_kernel` in interpret mode: the edge-padded [B, H+2P, C8,
    Wp] layout exactly, then one step and three chained steps on it (the
    kernel keeps the border itself), fp32 sums in the same chunks of 8:
    1e-6 abs over the C real channels of the whole canvas."""
    from excel_tpu.ops.par_pallas import pad_for_diffuse_hcw as jax_pad_hcw
    from excel_tpu.ops.par_pallas import par_diffuse_padded_hcw
    from excel_tpu_torch.ops.par_kernels import (
        pad_for_diffuse_hcw, par_diffuse_padded_hcw_reference)

    dil = (1, 2, 4)
    offs = _offsets(dil)
    _, masks, _ = _canvas(6, b=2, c=5, h=40, w=56)
    rng = np.random.default_rng(7)
    aff = rng.random((2, len(offs), 40, 56), dtype=np.float32)
    aff /= aff.sum(axis=1, keepdims=True)
    ref = jax_pad_hcw(jnp.asarray(masks), 4)
    got = pad_for_diffuse_hcw(t(masks), 4)
    np.testing.assert_array_equal(n(got), np.asarray(ref))
    for _ in range(3):
        ref = par_diffuse_padded_hcw(ref, jnp.asarray(aff), tuple(offs), 40,
                                     56, interpret=True)
        got = par_diffuse_padded_hcw_reference(got, t(aff), offs, 40, 56)
        np.testing.assert_allclose(n(got)[:, :, :5], np.asarray(ref)[:, :, :5],
                                   atol=1e-6)


def test_par_refine_full_extent_matches_row8_route():
    """fp32 `par_refine` without extents (the port: the diffusion kernel's
    plain version x 20, nothing between steps) against JAX's Pallas route
    for it (`use_pallas="interpret"`, no valid_hw: the padded loop of
    `_diffuse_hcw_kernel`), production dilations, 20 steps on 64 x 128.
    Tolerance 1e-5: affinity softmax and diffusion sums in another order."""
    img, masks, _ = _canvas(8, b=2, c=5)
    ref = jax_par_refine(jnp.asarray(img), jnp.asarray(masks),
                         dilations=DILATIONS, num_iter=20,
                         use_pallas="interpret")
    got = par_refine(t(img), t(masks), dilations=DILATIONS, num_iter=20)
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_step_is_valid_step_at_full_extent(dtype):
    """Plain row 6 (`par_diffuse_padded_reference`) equals plain row 7 with
    every image's extent the whole canvas, bit for bit over the whole
    canvas: the identity by which row 7's kernel computes row 6 on the
    card."""
    from excel_tpu_torch.ops.par_kernels import (
        pad_for_diffuse, par_diffuse_padded_reference,
        par_diffuse_padded_valid_reference)

    dil = (1, 8)
    offs = _offsets(dil)
    _, masks, _ = _canvas(9, b=2, c=5, h=40, w=56)
    rng = np.random.default_rng(10)
    aff = rng.random((2, len(offs), 40, 56), dtype=np.float32)
    aff /= aff.sum(axis=1, keepdims=True)
    mp = pad_for_diffuse(t(masks).to(dtype), 8)
    full = torch.tensor([[40, 56]] * 2, dtype=torch.int32)
    a = t(aff).to(dtype)
    for _ in range(3):
        step = par_diffuse_padded_reference(mp, a, offs, 40, 56)
        assert torch.equal(
            step, par_diffuse_padded_valid_reference(mp, a, full, offs, 40,
                                                     56))
        mp = step
