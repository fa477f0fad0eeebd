"""The port's trained forward (excel_tpu_torch.models.excel.excel_forward,
with the LVC head and the calibrated second pass) and its calibration
term against the JAX package's at tiny-config size on the CPU. The JAX
encoder runs its Pallas attention kernels in interpret mode; the port
takes its plain versions."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from excel_tpu.config import tiny_config
from excel_tpu.models import excel as jexcel
from excel_tpu.models import layers as jlayers
from excel_tpu_torch.config import tiny_config as port_tiny_config
from excel_tpu_torch.models import excel as pexcel
from excel_tpu_torch.models import layers as players
from torch_port_common import (jax_clip_tree, jax_head_tree,
                               jax_interpret_cfg, n, port_head, port_params,
                               t)

# fp32 through 4 encoder blocks and the head in other summation orders
# (observed below 3e-6 on values up to ~5)
ATOL = 2e-5
# the calibration mask is a softmax of fp32 cosines: 1e-6
EX_ATOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_interpret_cfg(tiny_config())
    pcfg = port_tiny_config()
    clip = jax_clip_tree(jcfg.clip, seed=0)
    head = jax_head_tree(jcfg, seed=1)
    rng = np.random.default_rng(2)
    images = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    text = rng.standard_normal((jcfg.num_fg + 3, jcfg.clip.embed_dim)).astype(
        np.float32)
    jparams = {"clip": clip, "head": head}
    pparams = {"clip": port_params(clip, pcfg.clip),
               "head": port_head(head, pcfg)}
    return jcfg, pcfg, jparams, pparams, images, text


@pytest.mark.parametrize("attn_mode", ["stack", "mean", "none"])
def test_excel_forward_matches_jax(setup, attn_mode):
    jcfg, pcfg, jparams, pparams, images, text = setup
    ref = jexcel.excel_forward(jparams, jnp.asarray(images), jnp.asarray(text),
                               jcfg, attn_mode=attn_mode)
    got = pexcel.excel_forward(pparams, t(images), t(text), pcfg,
                               attn_mode=attn_mode)
    for key in ("segs", "fused", "lams", "attn_weights", "attn_pred",
                "seg_attn"):
        g, r = getattr(got, key), getattr(ref, key)
        if r is None:
            assert g is None, key
            continue
        assert g.shape == r.shape, key
        np.testing.assert_allclose(n(g), np.asarray(r), atol=ATOL,
                                   err_msg=key)
    # the head trains through segs, seg_attn and attn_pred; fused returns
    # detached (the encoder never records a graph)
    assert got.segs.requires_grad and got.attn_pred.requires_grad
    assert got.seg_attn.requires_grad and not got.fused.requires_grad
    assert not got.lams.requires_grad


def test_calibrated_pass_matches_jax(setup):
    """The LAM-only second pass with the head's features as ex_feats (the
    same ex_feats on both sides)."""
    jcfg, pcfg, jparams, pparams, images, text = setup
    fused = jexcel.excel_forward(jparams, jnp.asarray(images),
                                 jnp.asarray(text), jcfg).fused
    ref = jexcel.excel_forward(jparams, jnp.asarray(images), jnp.asarray(text),
                               jcfg, ex_feats=fused)
    got = pexcel.excel_forward(pparams, t(images), t(text), pcfg,
                               ex_feats=t(np.asarray(fused)))
    plain = pexcel.excel_forward(pparams, t(images), t(text), pcfg).lams
    assert got.shape == ref.shape
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=ATOL)
    assert float((got - plain).abs().max()) > 1e-3     # ex changes the LAMs


def test_calibrated_pass_bf16_matches_jax(setup):
    """The same under the fast preset: the calibration mask is rounded to
    bf16 before the surgery blocks add it. LAMs (fp32, from bf16
    projections) within one bf16 ulp of their largest magnitude."""
    from excel_tpu.config import fast as jax_fast
    from excel_tpu.models.params import cast_matmul_weights as jax_cast
    from excel_tpu_torch.config import fast
    from excel_tpu_torch.models.params import cast_matmul_weights

    jcfg, pcfg, jparams, pparams, images, text = setup
    jcfg, pcfg = jax_fast(jcfg), fast(pcfg)
    jparams = dict(jparams, clip=jax_cast(jparams["clip"], jnp.bfloat16))
    pparams = dict(pparams, clip=cast_matmul_weights(pparams["clip"],
                                                     torch.bfloat16))
    fused = np.random.default_rng(3).standard_normal(
        (2, 16, jcfg.head.embedding_dim)).astype(np.float32)
    ref = np.asarray(jexcel.excel_forward(
        jparams, jnp.asarray(images), jnp.asarray(text), jcfg,
        ex_feats=jnp.asarray(fused)))
    with torch.inference_mode():
        got = pexcel.excel_forward(pparams, t(images), t(text), pcfg,
                                   ex_feats=t(fused))
    np.testing.assert_allclose(n(got.float()), ref, rtol=0,
                               atol=2.0 ** -7 * float(np.abs(ref).max()))


def test_external_feature_attention_matches_jax():
    """Cosines centred on the mean over the WHOLE batch (one image's mask
    depends on the other's features), scaled by 3, negatives to -inf."""
    rng = np.random.default_rng(4)
    ex = rng.standard_normal((2, 8, 4, 4)).astype(np.float32)
    got = n(players.external_feature_attention(t(ex)))
    ref = np.asarray(jlayers.external_feature_attention(jnp.asarray(ex)))
    np.testing.assert_allclose(got, ref, atol=EX_ATOL)
    assert (got == 0).any() and np.allclose(got.sum(-1), 1.0, atol=1e-6)
    alone = n(players.external_feature_attention(t(ex[:1])))
    assert not np.allclose(alone[0], got[0], atol=1e-3)


@pytest.mark.parametrize("fused_kernel", [False, True])
def test_surgery_attention_with_ex_matches_jax(setup, fused_kernel):
    """ex added to every head's patch-patch block: the per-head plain
    version, and the kernel route (plain version of the kernel on the CPU,
    ex padded with a zero CLS row and column) against JAX's interpret
    kernel."""
    jcfg, pcfg, jparams, pparams, _, _ = setup
    rng = np.random.default_rng(5)
    y = rng.standard_normal((2, 17, 64)).astype(np.float32)
    ex = rng.random((2, 16, 16)).astype(np.float32) / 16
    jblk = jparams["clip"]["visual"]["blocks"][-1]["attn"]
    pblk = pparams["clip"]["visual"]["blocks"][-1]["attn"]
    heads = jcfg.clip.vision_heads
    if fused_kernel:
        ref = jlayers.surgery_attention_fused(
            jnp.asarray(y), jblk, heads, ex_attn=jnp.asarray(ex),
            interpret=True)
        got = players.surgery_attention_fused(t(y), pblk, heads,
                                              ex_attn=t(ex))
    else:
        ref = jlayers.surgery_attention(jnp.asarray(y), jblk, heads,
                                        ex_attn=jnp.asarray(ex))
        got = players.surgery_attention(t(y), pblk, heads, ex_attn=t(ex))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(n(g), np.asarray(r), atol=ATOL)


def test_init_excel_params():
    cfg = port_tiny_config()
    params = pexcel.init_excel_params(cfg, {"visual": {}},
                                      torch.Generator().manual_seed(0),
                                      device="cpu")
    assert params["clip"] == {"visual": {}}
    assert params["head"].classifier["w"].shape == (cfg.num_classes,
                                                    cfg.head.embedding_dim)
    assert dataclasses.is_dataclass(pexcel.ExcelOutputs)
