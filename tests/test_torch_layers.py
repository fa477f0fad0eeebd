"""Port attention layers (excel_tpu_torch.models.layers) against the JAX
package's on one tiny-config block: the per-head plain functions and the
kernel wrappers (plain versions on CPU tensors; JAX's Pallas kernels in
interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from excel_tpu.config import tiny_config
from excel_tpu.models import layers as jl
from excel_tpu_torch.config import tiny_config as port_tiny_config
from excel_tpu_torch.models import layers as pl
from torch_port_common import jax_clip_tree, n, port_params, t

# fp32 products of one block in another summation order; outputs of
# magnitude ~1: 1e-5 abs
ATOL = 1e-5
HEADS = 2


@pytest.fixture(scope="module")
def block():
    tree = jax_clip_tree(tiny_config().clip, seed=3)
    jp = tree["visual"]["blocks"][0]["attn"]
    pp = port_params(tree, port_tiny_config().clip)["visual"]["blocks"][0][
        "attn"]
    y = np.random.default_rng(5).standard_normal((2, 17, 64)).astype(
        np.float32)
    return jp, pp, y


def _jax(name, jp, y):
    if name == "attention_fused":
        return jl.attention_fused(jnp.asarray(y), jp, HEADS, interpret=True)
    if name == "surgery_attention_fused":
        return jl.surgery_attention_fused(jnp.asarray(y), jp, HEADS,
                                          interpret=True)
    return getattr(jl, name)(jnp.asarray(y), jp, HEADS)


@pytest.mark.parametrize("name", ["attention", "surgery_attention",
                                  "attention_fused",
                                  "surgery_attention_fused"])
def test_attention_layer_matches_jax(block, name):
    jp, pp, y = block
    ref = _jax(name, jp, y)
    with torch.inference_mode():
        got = getattr(pl, name)(t(y), pp, HEADS)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(n(g), np.asarray(r), atol=ATOL)


@pytest.mark.parametrize("name", ["attention", "surgery_attention"])
def test_per_head_layers_refuse_non_cpu_tensors(block, name):
    _, pp, _ = block
    with pytest.raises(ValueError, match=f"{name}_fused"):
        getattr(pl, name)(torch.empty((1, 17, 64), device="meta"), pp, HEADS)


def test_bf16_elementwise_layers_match_jax(block):
    """LayerNorm (fp32 inside), QuickGELU and linear in bf16, op by op as
    the JAX package runs them: equal (the constant 1.702 rounded to bf16
    and the sigmoid as 1 / (1 + exp(-z)), as JAX writes them)."""
    _, _, y = block
    tree = jax_clip_tree(tiny_config().clip, seed=3)
    blk = tree["visual"]["blocks"][0]
    pblk = port_params(tree, port_tiny_config().clip)["visual"]["blocks"][0]
    yj = jnp.asarray(y).astype(jnp.bfloat16)
    yt = t(np.asarray(yj.astype(jnp.float32))).bfloat16()
    fc_j = {k: jnp.asarray(v).astype(jnp.bfloat16)
            for k, v in blk["mlp"]["fc"].items()}
    fc_t = {k: v.bfloat16() for k, v in pblk["mlp"]["fc"].items()}
    for got, ref in ((pl.layer_norm(yt, pblk["ln_1"]),
                      jl.layer_norm(yj, blk["ln_1"])),
                     (pl.quick_gelu(yt), jl.quick_gelu(yj)),
                     (pl.linear(yt, fc_t), jl.linear(yj, fc_j))):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(n(got.float()),
                                      np.asarray(ref.astype(jnp.float32)))
