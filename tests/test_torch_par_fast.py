"""The fast preset's PAR kernels (excel_tpu_torch.ops.par_kernels:
pad_replicate_valid, par_affinity, par_diffuse_padded_valid,
par_diffuse_valid_resident) and the bf16 route of par_refine against the
JAX package's Pallas functions in interpret mode, in fp32 and in bf16."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from excel_tpu.ops import par_pallas as jp
from excel_tpu.ops.par import _offsets as jax_offsets
from excel_tpu_torch.ops import par_kernels as pk
from excel_tpu_torch.ops.par import _offsets, _pos_weight, par_refine
from torch_port_common import n, t

# (1, 2, 8): pad 8 and three dilations (K=24) keep interpret mode quick;
# the production set is (1, 2, 4, 8, 12, 24)
DILATIONS = (1, 2, 8)
PAD = 8
B, C, H, W = 3, 4, 40, 128
VALID = np.asarray([[40, 128], [33, 100], [17, 61]], np.int32)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# one bf16 ulp of a value in [0.5, 1): XLA on the CPU keeps some bf16
# products in fp32 (its default excess precision), so a sum can round to
# the neighbouring bf16 value
BF16_ULP = 2.0 ** -8


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    tdt, jdt = DTYPES[dtype]
    j = jnp.asarray(a).astype(jdt)
    return j, t(np.asarray(j.astype(jnp.float32))).to(tdt)


def _close(got, ref, atol, rtol=0.0):
    np.testing.assert_allclose(n(got.float()),
                               np.asarray(ref.astype(jnp.float32)), atol=atol,
                               rtol=rtol)


def _offsets_t():
    return _offsets(DILATIONS)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pad", [8, 24])
def test_pad_replicate_valid_matches_pallas(dtype, pad):
    """A clamped copy: equal, element for element, slack included."""
    x = np.random.default_rng(pad).random((B, C, H, W), dtype=np.float32)
    xj, xt = _pair(x, dtype)
    ref = jp.pad_replicate_valid(xj, jnp.asarray(VALID), pad, interpret=True)
    got = pk.pad_replicate_valid(xt, t(VALID), pad)
    assert got.shape == ref.shape and got.dtype == xt.dtype
    np.testing.assert_array_equal(n(got.float()),
                                  np.asarray(ref.astype(jnp.float32)))


# bf16: one bf16 ulp of each affinity's own size (2^-7 |ref|), so that the
# w2 * position term (up to 1.5e-3 here) cannot go missing unseen, plus the
# smallest normal fp32 for the far offsets' subnormal affinities, which XLA
# flushes to zero
@pytest.mark.parametrize("dtype,atol,rtol", [
    ("f32", 2e-6, 0.0), ("bf16", float(np.finfo(np.float32).tiny), 2.0 ** -7)])
def test_par_affinity_matches_pallas(dtype, atol, rtol):
    """fp32 in both; the TPU kernel's order of rounding, but XLA contracts
    some products into FMAs and rounds exp differently: observed 1.2e-6 in
    fp32 on affinities below 1, and one bf16 ulp in bf16."""
    img = np.random.default_rng(1).standard_normal((B, 3, H, W)).astype(
        np.float32)
    ip = np.asarray(jp.pad_replicate_valid(jnp.asarray(img),
                                           jnp.asarray(VALID), PAD,
                                           interpret=True))
    pos_w = tuple(float(v) for v in _pos_weight(DILATIONS))
    ref = jp.par_affinity(jnp.asarray(ip), tuple(jax_offsets(DILATIONS)),
                          pos_w, H, W, out_dtype=DTYPES[dtype][1],
                          interpret=True)
    got = pk.par_affinity(t(ip), _offsets_t(), pos_w, H, W,
                          out_dtype=DTYPES[dtype][0])
    assert got.shape == ref.shape
    _close(got, ref, atol, rtol)


def _diffusion_inputs(seed: int, dtype: str, c: int = C, valid=VALID):
    rng = np.random.default_rng(seed)
    k = len(_offsets(DILATIONS))
    aff = rng.random((B, k, H, W), dtype=np.float32)
    aff /= aff.sum(axis=1, keepdims=True)
    masks = rng.random((B, c, H, W), dtype=np.float32)
    affj, afft = _pair(aff, dtype)
    mj, _ = _pair(masks, dtype)
    mpj = jp.pad_replicate_valid(mj, jnp.asarray(valid), PAD, interpret=True)
    mpt = t(np.asarray(mpj.astype(jnp.float32))).to(DTYPES[dtype][0])
    return mpj, affj, mpt, afft


# fp32: one ulp (XLA contracts products into FMAs); bf16: one bf16 ulp
@pytest.mark.parametrize("dtype,atol", [("f32", 1e-6), ("bf16", BF16_ULP)])
def test_par_diffuse_padded_valid_matches_pallas(dtype, atol):
    mpj, affj, mpt, afft = _diffusion_inputs(2, dtype)
    ref = jp.par_diffuse_padded_valid(mpj, affj, jnp.asarray(VALID),
                                      tuple(jax_offsets(DILATIONS)), H, W,
                                      interpret=True)
    got = pk.par_diffuse_padded_valid(mpt, afft, t(VALID), _offsets_t(), H, W)
    assert got.shape == ref.shape and got.dtype == mpt.dtype
    _close(got, ref, atol)


# valid extents with a one-pixel row, a one-pixel column and a width that
# is no multiple of 8: the CUDA kernel's edge paths (its 16-byte copies of
# 8 pixels do not fit there), held here through the plain version it is
# compared with on the card
EDGE_VALID = np.asarray([[1, 128], [33, 1], [17, 61]], np.int32)
# (channels, extents): the eval batch's C=4, and C = 1, 5 (VOC train) and
# 9 (COCO train: more channels than the kernel sums in one pass)
CHANNEL_CASES = [(4, VALID), (1, EDGE_VALID), (5, EDGE_VALID),
                 (9, EDGE_VALID)]


@pytest.mark.parametrize("c,valid", CHANNEL_CASES)
@pytest.mark.parametrize("dtype,atol", [("f32", 1e-6), ("bf16", BF16_ULP)])
def test_par_diffuse_valid_resident_matches_pallas(dtype, atol, c, valid):
    """5 steps; the per-step ulps do not grow beyond one (the diffusion
    averages)."""
    mpj, affj, mpt, afft = _diffusion_inputs(3, dtype, c, valid)
    ref = jp.par_diffuse_valid_resident(mpj, affj, jnp.asarray(valid),
                                        tuple(jax_offsets(DILATIONS)), H, W,
                                        5, interpret=True)
    got = pk.par_diffuse_valid_resident(mpt, afft, t(valid), _offsets_t(), H,
                                        W, 5)
    _close(got, ref, atol)


@pytest.mark.parametrize("c,valid", CHANNEL_CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_resident_equals_iterated_steps(dtype, c, valid):
    """The port's resident version is the step version iterated, bit for
    bit (what the card checks of the two kernels)."""
    _, _, mpt, afft = _diffusion_inputs(4, dtype, c, valid)
    m = mpt
    for _ in range(4):
        m = pk.par_diffuse_padded_valid(m, afft, t(valid), _offsets_t(), H, W)
    got = pk.par_diffuse_valid_resident(mpt, afft, t(valid), _offsets_t(), H,
                                        W, 4)
    assert torch.equal(got, m)


def test_par_refine_bf16_full_extent():
    """Without valid extents the bf16 route clamps at the full canvas,
    which is plain edge padding: the same result as explicit extents."""
    rng = np.random.default_rng(6)
    img = rng.standard_normal((2, 3, 24, 40)).astype(np.float32)
    masks = rng.random((2, 3, 24, 40), dtype=np.float32)
    full = np.asarray([[24, 40]] * 2, np.int32)
    a = par_refine(t(img), t(masks), dilations=(1, 8), num_iter=3,
                   dtype=torch.bfloat16)
    b = par_refine(t(img), t(masks), dilations=(1, 8), num_iter=3,
                   valid_hw=t(full), dtype=torch.bfloat16)
    assert torch.equal(a, b)


def test_par_wrappers_check_inputs():
    _, _, mpt, afft = _diffusion_inputs(7, "bf16")
    offs = _offsets_t()
    with pytest.raises(ValueError, match="share a dtype"):
        pk.par_diffuse_padded_valid(mpt, afft.float(), t(VALID), offs, H, W)
    with pytest.raises(ValueError):
        pk.par_diffuse_padded_valid(mpt[:, :, :50], afft, t(VALID), offs, H,
                                    W)
    with pytest.raises(ValueError, match="int32"):
        pk.pad_replicate_valid(mpt, t(VALID).long(), PAD)
    with pytest.raises(NotImplementedError):
        pk.pad_replicate_valid(mpt.half(), t(VALID), PAD)
    with pytest.raises(ValueError):
        pk.par_diffuse_valid_resident(mpt, afft, t(VALID), offs, H, W, 0)
    with pytest.raises(ValueError):
        pk.par_affinity(torch.zeros((1, 3, 56, 256)), offs[:20], [0.0] * 20,
                        H, W)


@pytest.mark.parametrize("pad,rows,plane,words", [
    (8, 32, 9216, 3840), (16, 32, 9216, 6144), (24, 32, 9216, 8960),
    (25, 16, 9216, 7656), (30, 8, 9216, 8432), (32, 8, 9216, 9216),
    (33, 32, 19328, 12936), (45, 32, 19328, 19032), (46, 16, 19328, 16848),
    (52, 8, 19328, 18816)])
def test_affinity_tiling_from_the_pad(pad, rows, plane, words):
    """The affinity kernel's tiles: a channel of the slab (the tile with its
    halo, rows padded to 4 words) within 9,216 words, whose 3 channels let
    two blocks share an SM's 228 KiB, as the paths' pad 24 does with 32
    rows; fewer rows for larger pads; beyond pad 32 within 19,328 words (one
    block of at most 227 KiB)."""
    assert pk.affinity_tiling(pad) == (rows, plane)
    assert pk.affinity_slab_words(rows, pad) == words <= plane
    assert 2 * (3 * 9216 * 4 + 1024) <= 233472
    assert 3 * 19328 * 4 <= 232448


def test_affinity_kernel_takes_pads_up_to_52():
    assert pk.affinity_tiling(53) == (0, 0)
    img = torch.zeros((1, 3, 40 + 2 * 53 + 8, 256))
    offs = [(53, 53)] * 8
    # the plain version takes any pad; on the card the slab kernel takes
    # pads up to 52 and the direct kernel the rest
    assert pk.affinity_kernel(52, 8) == "slab"
    assert pk.affinity_kernel(53, 8) == "direct"
    assert pk.par_affinity(img, offs, [0.0] * 8, 40, 100).shape == (
        1, 8, 40, 100)


def _third_fast(s: np.ndarray) -> np.ndarray:
    """csrc/par_affinity.cu's third_fast on float32 s: q = RN(s * RN(1/3)),
    r = fma(-q, 3, s), RN(q + r * RN(1/3)) (one FMA), each step emulated in
    float64, where its operations are exact, then rounded once."""
    y = np.float64(np.float32(1.0) / np.float32(3.0))
    s64 = s.astype(np.float64)
    q = (s64 * y).astype(np.float32).astype(np.float64)
    r = (s64 - 3.0 * q).astype(np.float32).astype(np.float64)
    return (q + r * y).astype(np.float32)


def _assert_third(got: np.ndarray, s: np.ndarray) -> None:
    np.testing.assert_array_equal(got.view(np.uint32),
                                  (s / np.float32(3.0)).view(np.uint32))


@pytest.mark.parametrize("exponent", [-100, -99, -1, 0, 64, 125, 126, 127])
def test_division_by_three_as_product_and_fma_correction(exponent):
    """The affinity kernel divides a logit's sum s by 3 with third_fast
    where s is 0 or lies in [2^-100, inf): that equals float32 division (the
    previous kernel's __fdiv_rn) for every mantissa, at both ends of the
    range and between (the steps scale exactly with the exponent)."""
    assert np.float32(1.0 / 3.0).view(np.uint32) == 0x3EAAAAAB
    assert np.float32(2.0 ** -100).view(np.uint32) == 0x0D800000
    for part in np.array_split(np.arange(1 << 23, dtype=np.uint32), 4):
        s = ((np.uint32(exponent + 127) << np.uint32(23)) | part).view(
            np.float32)
        _assert_third(_third_fast(s), s)
    zero = np.zeros(1, np.float32)
    _assert_third(_third_fast(zero), zero)   # +0, as 0 / 3


def test_division_by_three_below_the_fast_range():
    """third_exact's other paths: every s below 3 * 2^-126 (its quotient is
    subnormal or 0) as the integer (m + 1) / 3 of s = m 2^-149; a sample of
    every binade of [3 * 2^-126, 2^-100) through third_fast at s * 2^64,
    scaled back; inf and NaN."""
    assert np.float32(3 * 2.0 ** -126).view(np.uint32) == 0x01400000
    with open(os.path.join(os.path.dirname(pk.__file__), os.pardir, "csrc",
                           "par_affinity.cu")) as f:
        src = f.read()
    assert all(c in src for c in ("0x01400000u", "0x0D800000u",
                                  "0x7F800000u", "0x1.555556p-2f"))
    for part in np.array_split(np.arange(0x01400000, dtype=np.uint32), 8):
        e = part >> np.uint32(23)
        m = np.where(e == 0, part, ((part & np.uint32(0x7FFFFF))
                                    | np.uint32(0x800000))
                     << np.maximum(e, np.uint32(1)) - np.uint32(1))
        _assert_third(((m + np.uint32(1)) // np.uint32(3)).astype(np.uint32)
                      .view(np.float32), part.view(np.float32))
    rng = np.random.default_rng(0)
    bits = np.concatenate([
        (np.uint32(e) << np.uint32(23)) | rng.integers(
            0, 1 << 23, 1 << 14, dtype=np.uint32) for e in range(2, 27)])
    s = bits[(bits >= 0x01400000) & (bits < 0x0D800000)].view(np.float32)
    got = (_third_fast(s * np.float32(2.0 ** 64)).astype(np.float64)
           * 2.0 ** -64).astype(np.float32)
    _assert_third(got, s)
    special = np.asarray([np.inf, np.nan], np.float32)
    with np.errstate(invalid="ignore"):
        third = special * np.float32(1.0 / 3.0)
    assert np.isinf(third[0]) and np.isnan(third[1])


# (dilations, route, affinity kernel): every 8-aligned pad takes the padded
# route, as in the JAX package; the card's affinity runs its slab kernel
# where the slab fits shared memory (pads up to 52) and K <= 64, its direct
# kernel elsewhere
ROUTES = [((1, 2, 4, 8, 12, 24), "padded", "slab"),              # pad 24
          ((1, 2, 4, 8, 12, 48), "padded", "slab"),              # pad 48
          ((1, 2, 4, 8, 12, 24, 32), "padded", "slab"),          # K=56
          ((1, 2, 4, 8, 12, 24, 56), "padded", "direct"),        # pad 56
          ((1, 2, 4, 8, 12, 24, 64), "padded", "direct"),        # pad 64
          ((1, 2, 4, 8, 12, 16, 24, 32, 40), "padded", "direct"),  # K=72
          ((1, 2, 4, 8, 12, 52), "per_step", None),              # pad 52
          ((1, 2), "per_step", None)]                            # pad 2


@pytest.mark.parametrize("dilations,route,kernel", ROUTES)
def test_bf16_route_from_the_shapes(dilations, route, kernel):
    from excel_tpu_torch.ops.par import bf16_route

    assert bf16_route(dilations) == route
    k, pad = len(_offsets(dilations)), max(dilations)
    if kernel is not None:
        assert pk.affinity_kernel(pad, k) == kernel
        assert k <= pk.PADDED_MAX_OFFSETS and pad <= pk.PADDED_MAX_PAD


# the dilations of the slab's limits: pad 56 (K=56), no slab that fits;
# nine dilations (K=72, pad 40), more logits than the slab kernel holds
LARGE = [(1, 2, 4, 8, 12, 24, 56), (1, 2, 4, 8, 12, 16, 24, 32, 40)]


@pytest.mark.parametrize("dilations", LARGE)
def test_par_affinity_beyond_the_slab_matches_pallas(dilations):
    """The plain version that the direct kernel is held to on the card,
    against the Pallas affinity where the JAX package runs it: within a
    bf16 ulp, as test_par_affinity_matches_pallas."""
    h, w = 24, 128
    pad = max(dilations)
    img = np.random.default_rng(9).standard_normal((2, 3, h, w)).astype(
        np.float32)
    valid = np.asarray([[24, 128], [17, 93]], np.int32)
    ip = np.asarray(jp.pad_replicate_valid(jnp.asarray(img),
                                           jnp.asarray(valid), pad,
                                           interpret=True))
    pos_w = tuple(float(v) for v in _pos_weight(dilations))
    ref = jp.par_affinity(jnp.asarray(ip), tuple(jax_offsets(dilations)),
                          pos_w, h, w, out_dtype=jnp.bfloat16, interpret=True)
    got = pk.par_affinity(t(ip), _offsets(dilations), pos_w, h, w)
    assert got.shape == ref.shape
    _close(got, ref, float(np.finfo(np.float32).tiny), 2.0 ** -7)


def test_per_step_route_raises_only_without_a_halo_that_fits():
    """Row 5's step (the per-step route, the CRF's message pass) stages the
    whole reach in bf16, a pad of 56 included; in fp32 it raises where no
    chunk's halo fits shared memory."""
    assert pk.staged_pad(tuple(_offsets((1, 2, 4, 8, 12, 24, 56))), 5,
                         2) == 56
    with pytest.raises(NotImplementedError, match="no halo"):
        pk.staged_pad(tuple(_offsets((300,))), 1, 4)
