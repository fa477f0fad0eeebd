"""The port's text side against the JAX package's: the text tower
(`text_forward`, `encode_text_ensemble`) at the tiny config's text widths,
TSE (`attr_aggregate`, tied logits included, and `load_attr_bank`), and
`build_text_bank` at ViT-B/16's text widths over the real VOC vocabulary
and the shipped attribute bank. Inputs from numpy seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from excel_tpu.config import ClipConfig as JaxClipConfig
from excel_tpu.config import tiny_config, voc_config
from excel_tpu.models import clip as jclip
from excel_tpu.models.excel import build_text_bank as jax_build_text_bank
from excel_tpu.models.params import init_clip_params as jax_init_clip_params
from excel_tpu.ops.tse import attr_aggregate as jax_attr_aggregate
from excel_tpu.text.class_names import prompt_vocabulary
from excel_tpu_torch.config import ClipConfig, asset_path
from excel_tpu_torch.config import tiny_config as port_tiny_config
from excel_tpu_torch.config import voc_config as port_voc_config
from excel_tpu_torch.models import clip as pclip
from excel_tpu_torch.ops.tse import attr_aggregate, load_attr_bank
from torch_port_common import jax_clip_tree, n, port_params, t

# fp32: the two packages sum the products in different orders
TOL_FP32 = 1e-5
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tokens(rng, shape, context, vocab):
    """Random token rows: an EOT id (the largest) at a random position,
    zeros after it, as tokenize frames them."""
    tok = rng.integers(1, vocab - 2, shape + (context,)).astype(np.int32)
    flat = tok.reshape(-1, context)
    for row in flat:
        eot = rng.integers(2, context)
        row[eot] = vocab - 1
        row[eot + 1:] = 0
    return tok


@pytest.fixture(scope="module")
def tiny():
    jcfg, pcfg = tiny_config(), port_tiny_config()
    tree = jax_clip_tree(jcfg.clip, seed=0)
    tok = _tokens(np.random.default_rng(0), (5, 3),
                  jcfg.clip.context_length, jcfg.clip.vocab_size)
    return jcfg, pcfg, tree, port_params(tree, pcfg.clip), tok


def _cfgs(jcfg, pcfg, dtype):
    jd, pd = DTYPES[dtype]
    return (dataclasses.replace(jcfg.clip, compute_dtype=jd),
            dataclasses.replace(pcfg.clip, compute_dtype=pd))


def _assert_close(got, ref, dtype):
    """fp32 within TOL_FP32; bf16 within one bf16 ulp of the array's largest
    magnitude, 2^-7 of it: in-process, XLA keeps some bf16 squares and
    products in fp32 (its excess precision), which moves a norm and with it
    a few outputs by one or two ulps of their own size (observed 54 of 160
    on 3 templates; bit for bit once XLA rounds as written:
    tests/test_torch_bf16_rounding.py)."""
    ref = np.asarray(ref.astype(jnp.float32))
    atol = TOL_FP32 if dtype == "fp32" else 2.0 ** -7 * np.abs(ref).max()
    np.testing.assert_allclose(n(got.float()), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_text_forward_matches(tiny, dtype):
    jcfg, pcfg, tree, params, tok = tiny
    jc, pc = _cfgs(jcfg, pcfg, dtype)
    ref = jclip.text_forward(tree, jnp.asarray(tok[:, 0]), jc)
    got = pclip.text_forward(params, t(tok[:, 0]), pc)
    assert got.dtype == DTYPES[dtype][1] and got.shape == ref.shape
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_encode_text_ensemble_matches(tiny, dtype):
    jcfg, pcfg, tree, params, tok = tiny
    jc, pc = _cfgs(jcfg, pcfg, dtype)
    ref = jclip.encode_text_ensemble(tree, jnp.asarray(tok), jc)
    got = pclip.encode_text_ensemble(params, t(tok), pc)
    assert got.shape == (5, jcfg.clip.embed_dim)
    _assert_close(got, ref, dtype)


def test_text_attention_grads_flow_in_fp32(tiny):
    """The masked attention stays differentiable (the head's decoder runs
    the same function): a causal row sees no later token."""
    from excel_tpu_torch.models.layers import multi_head_attention

    _, pcfg, _, params, _ = tiny
    blk = params["text"]["blocks"][0]
    y = torch.randn(2, 5, pcfg.clip.text_width, requires_grad=True)
    mask = torch.triu(torch.full((5, 5), -torch.inf), diagonal=1)
    out, w = multi_head_attention(y, blk["attn"], pcfg.clip.text_heads, mask)
    assert torch.equal(w.triu(1), torch.zeros_like(w))
    out[:, 0].sum().backward()
    assert torch.equal(y.grad[:, 1:], torch.zeros_like(y.grad[:, 1:]))


@pytest.mark.parametrize("case", ["random", "tied"])
def test_attr_aggregate_matches(case):
    """Random inputs within TOL_FP32; and small dyadic inputs with duplicate
    bank columns, whose logits tie exactly, so the dropped columns must be
    the same ones (a different choice moves whole softmax entries)."""
    rng = np.random.default_rng(1)
    if case == "random":
        text = rng.normal(size=(9, 16)).astype(np.float32)
        bank = rng.normal(size=(16, 30)).astype(np.float32)
    else:
        text = rng.integers(-2, 3, (9, 16)).astype(np.float32) / 4
        cols = rng.integers(-2, 3, (16, 6)).astype(np.float32) / 4
        bank = cols[:, rng.integers(0, 6, 30)]
    ref = np.asarray(jax_attr_aggregate(jnp.asarray(text), jnp.asarray(bank),
                                        6))
    got = attr_aggregate(t(text), t(bank), 6)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), ref, atol=TOL_FP32, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(n(got), axis=1), 1.0,
                               atol=1e-6)
    # bf16 text features: fp32 throughout, as the JAX function
    ref16 = np.asarray(jax_attr_aggregate(
        jnp.asarray(text).astype(jnp.bfloat16), jnp.asarray(bank), 6))
    got16 = attr_aggregate(t(text).to(torch.bfloat16), t(bank), 6)
    np.testing.assert_allclose(n(got16), ref16, atol=TOL_FP32, rtol=0)


def test_load_attr_bank():
    path = asset_path("attributes", "pascal_voc_bank_112.npz")
    bank, flags = load_attr_bank(path, device="cpu")
    assert tuple(bank.shape) == (512, 112) and tuple(flags.shape) == (20, 112)
    with np.load(path) as z:
        np.testing.assert_array_equal(n(bank), z["cluster_bank"])
        np.testing.assert_array_equal(n(flags), z["class_flags"])


def _full_text_tiny_vision():
    """ViT-B/16's text tower (512 wide, 8 heads, 12 layers, context 77,
    vocabulary 49,408) with the tiny config's vision tower."""
    small = dict(image_size=64, vision_width=64, vision_layers=2,
                 vision_heads=2, pretrain_grid=2, surgery_blocks=1)
    return JaxClipConfig(**small), ClipConfig(**small)


def test_build_text_bank_full_width_matches():
    """45 VOC prompts through the full-width text tower and TSE over the
    shipped [512, 112] bank, as the port's CLIs build it
    (`cli.common.load_text_bank` without --random-init): fp32 within
    TOL_FP32 of the JAX package's `build_text_bank`."""
    import argparse

    from excel_tpu_torch.cli.common import load_text_bank

    jclip_cfg, pclip_cfg = _full_text_tiny_vision()
    jcfg = dataclasses.replace(voc_config(), clip=jclip_cfg)
    pcfg = dataclasses.replace(port_voc_config(), clip=pclip_cfg)
    tree = jax.device_get(jax_init_clip_params(jax.random.PRNGKey(0),
                                               jclip_cfg))
    with np.load(asset_path("attributes", "pascal_voc_bank_112.npz")) as z:
        bank = z["cluster_bank"]
    vocab = prompt_vocabulary("pascal_voc")
    assert len(vocab) == 45
    ref = np.asarray(jax_build_text_bank(tree, jcfg, vocab,
                                         jnp.asarray(bank)))
    args = argparse.Namespace(random_init=False, dataset="voc", tiny=False)
    got = load_text_bank(args, pcfg, port_params(tree, pclip_cfg),
                         torch.device("cpu"))
    assert got.shape == (45, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), ref, atol=TOL_FP32, rtol=0)
