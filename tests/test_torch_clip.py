"""Port encoder (excel_tpu_torch.models.clip.encode_image) against the JAX
package's on one tiny-config input, in every attention mode. The port has
one route (the kernel wrappers, plain versions on CPU tensors); it is held
against both JAX routes, the per-head jnp path and the Pallas kernels in
interpret mode."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from excel_tpu.config import tiny_config
from excel_tpu.models.clip import encode_image as jax_encode
from excel_tpu_torch.config import tiny_config as port_tiny_config
from excel_tpu_torch.models.clip import encode_image, interpolate_pos_embedding
from torch_port_common import jax_clip_tree, n, port_params, t

# fp32 through 4 blocks in another summation order: observed max |diff|
# 2.9e-6 on features up to 4.7 in magnitude; 2e-5 leaves ~7x margin
ATOL = 2e-5


@pytest.fixture(scope="module")
def inputs():
    tree = jax_clip_tree(tiny_config().clip, seed=0)
    img = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    return tree, img


# jax_fused: the JAX route the port is held against
@pytest.mark.parametrize("jax_fused", [False, True])
@pytest.mark.parametrize("attn_mode", ["stack", "mean", "none"])
def test_encode_image_matches_jax(inputs, jax_fused, attn_mode):
    tree, img = inputs
    jcfg = dataclasses.replace(
        tiny_config().clip,
        fused_attention="interpret" if jax_fused else False)
    pcfg = port_tiny_config().clip
    ref = jax_encode(tree, jnp.asarray(img), jcfg, attn_mode=attn_mode)
    with torch.inference_mode():
        got = encode_image(port_params(tree, pcfg), t(img), pcfg,
                           attn_mode=attn_mode)
    for key in ("projected", "feats", "attn"):
        if attn_mode == "none" and key == "attn":
            assert got["attn"] is None and ref["attn"] is None
            continue
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(n(got[key]), np.asarray(ref[key]),
                                   atol=ATOL, err_msg=key)


def test_pos_embedding_upsample_matches_jax():
    from excel_tpu.models.clip import interpolate_pos_embedding as jax_interp

    pos = np.random.default_rng(4).standard_normal((14 * 14 + 1, 8)).astype(
        np.float32)
    np.testing.assert_allclose(n(interpolate_pos_embedding(t(pos), 20)),
                               np.asarray(jax_interp(jnp.asarray(pos), 20)),
                               atol=1e-6)
    # below the pretrained grid the JAX package's resize antialiases, and
    # so does the port
    np.testing.assert_allclose(n(interpolate_pos_embedding(t(pos), 10)),
                               np.asarray(jax_interp(jnp.asarray(pos), 10)),
                               atol=1e-6)


@pytest.mark.parametrize("side,new_side", [(4, 3), (14, 10), (14, 7), (2, 1),
                                           (14, 36), (14, 56)])
def test_pos_embedding_resize_matches_jax(side, new_side):
    """Downsampling (antialiased: triangle kernel widened by 1 / scale,
    edge weights renormalised) and the MSC upsamples 14 -> 36 / 56, against
    `jax.image.resize(..., "linear")`: 1e-6 on a standard-normal table. The
    CLS row passes through."""
    from excel_tpu.models.clip import interpolate_pos_embedding as jax_interp

    pos = np.random.default_rng(5).standard_normal(
        (side * side + 1, 8)).astype(np.float32)
    got = n(interpolate_pos_embedding(t(pos), new_side))
    assert got.shape == (new_side * new_side + 1, 8)
    np.testing.assert_array_equal(got[0], pos[0])
    np.testing.assert_allclose(
        got, np.asarray(jax_interp(jnp.asarray(pos), new_side)), atol=1e-6)
    if new_side < side and side % new_side:
        # torch's own bilinear resize does not antialias: not this function
        # (at 2 -> 1 both are the mean of the four entries)
        import torch.nn.functional as F
        grid = t(pos[1:]).reshape(side, side, 8).permute(2, 0, 1)[None]
        plain = F.interpolate(grid, size=(new_side, new_side),
                              mode="bilinear", align_corners=False)
        assert not np.allclose(
            got[1:], n(plain[0].permute(1, 2, 0).reshape(-1, 8)), atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [16, 48, 80])
def test_vision_forward_at_msc_sizes_matches_jax(size, dtype):
    """attn_mode="none" at other input sizes than the configured one, as
    MSC runs the encoder: 16 px (a 1 x 1 grid, below the tiny config's
    pretrained 2 x 2 table), 48 and 80 px (grids 3 and 5). fp32: 1e-4 on
    the projected tokens; bf16: one bf16 ulp of the array's largest
    magnitude (the GEMM libraries round sums differently,
    tests/test_torch_bf16_rounding.py)."""
    from excel_tpu.config import fast as jax_fast
    from excel_tpu.models.clip import vision_forward as jax_vision_forward
    from excel_tpu.models.params import cast_matmul_weights as jax_cast
    from excel_tpu_torch.config import fast
    from excel_tpu_torch.models.clip import vision_forward
    from excel_tpu_torch.models.params import cast_matmul_weights

    jcfg, pcfg = tiny_config(), port_tiny_config()
    if dtype == "bfloat16":
        jcfg, pcfg = jax_fast(jcfg), fast(pcfg)
    jclip = dataclasses.replace(jcfg.clip, fused_attention="interpret",
                                image_size=size)
    pclip = dataclasses.replace(pcfg.clip, image_size=size)
    tree = jax_clip_tree(jclip)
    params = port_params(tree, pclip)
    if dtype == "bfloat16":
        tree = jax_cast(tree, jnp.bfloat16)
        params = cast_matmul_weights(params, torch.bfloat16)
    images = np.random.default_rng(6).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    ref = jax_vision_forward(tree, jnp.asarray(images), jclip,
                             attn_mode="none")
    with torch.inference_mode():
        got = vision_forward(params, t(images), pclip, attn_mode="none")
    assert got["attn"] is None and ref["attn"] is None
    tokens = (size // 16) ** 2 + 1
    assert got["projected"].shape == (2, tokens, pclip.embed_dim)
    want = np.asarray(ref["projected"].astype(jnp.float32))
    atol = ATOL if dtype == "float32" else 2.0 ** -7 * float(
        np.abs(want).max())
    np.testing.assert_allclose(n(got["projected"].float()), want, atol=atol,
                               rtol=0)


def test_unported_modes_raise():
    tree = jax_clip_tree(tiny_config().clip)
    pcfg = port_tiny_config().clip
    params = port_params(tree, pcfg)
    img = torch.zeros((1, 64, 64, 3))
    # ex_feats (the trained forward's calibrated pass) is ported: zero
    # features give a uniform calibration mask, which moves the dense stream
    calibrated = encode_image(params, img, pcfg, attn_mode="none",
                              ex_feats=torch.zeros((1, 64, 4, 4)))
    plain = encode_image(params, img, pcfg, attn_mode="none")
    assert calibrated["projected"].shape == plain["projected"].shape
    assert torch.isfinite(calibrated["projected"]).all()
    assert not torch.allclose(calibrated["projected"], plain["projected"])
    with pytest.raises(NotImplementedError):
        encode_image(params, img, dataclasses.replace(
            pcfg, compute_dtype=torch.float16))


@pytest.mark.parametrize("attn_mode", ["stack", "mean", "none"])
def test_encode_image_bf16_matches_jax(inputs, attn_mode):
    """The fast preset's bf16 encoder against the JAX package's on its
    Pallas kernels (interpret mode, run op by op, so XLA rounds each bf16
    op as the port does), with the matmul weights cast once to bf16 on both
    sides. bf16 outputs within one bf16 ulp of each array's largest
    magnitude (observed: equal); the fp32 attention within 1e-6 (fp32 sums
    in another order; observed 9e-8)."""
    from excel_tpu.config import fast as jax_fast
    from excel_tpu.models.params import cast_matmul_weights as jax_cast
    from excel_tpu_torch.config import fast
    from excel_tpu_torch.models.params import cast_matmul_weights

    tree, img = inputs
    jcfg = dataclasses.replace(jax_fast(tiny_config()).clip,
                               fused_attention="interpret")
    pcfg = fast(port_tiny_config()).clip
    ref = jax_encode(jax_cast(tree, jnp.bfloat16), jnp.asarray(img), jcfg,
                     attn_mode=attn_mode)
    with torch.inference_mode():
        got = encode_image(cast_matmul_weights(port_params(tree, pcfg),
                                               torch.bfloat16),
                           t(img), pcfg, attn_mode=attn_mode)
    for key in ("projected", "feats", "attn"):
        if attn_mode == "none" and key == "attn":
            assert got["attn"] is None and ref["attn"] is None
            continue
        r = np.asarray(ref[key].astype(jnp.float32))
        assert got[key].dtype == (torch.float32 if key == "attn"
                                  else torch.bfloat16), key
        atol = 1e-6 if key == "attn" else 2.0 ** -7 * float(np.abs(r).max())
        np.testing.assert_allclose(n(got[key].float()), r, atol=atol, rtol=0,
                                   err_msg=key)
