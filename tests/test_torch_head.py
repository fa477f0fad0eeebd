"""The port's LVC head (excel_tpu_torch.models.head) against the JAX
package's at tiny-config size on the CPU: the forward with dropout off,
the gradients of the head's parameters, the converter's names, and the
Dropout2d draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from excel_tpu.config import tiny_config
from excel_tpu.models import head as jhead
from excel_tpu_torch.config import tiny_config as port_tiny_config
from excel_tpu_torch.models import head as phead
from excel_tpu_torch.models.params import head_to_jax_tree
from torch_port_common import jax_head_tree, n, port_head, t

# fp32 matmuls and softmaxes summed in other orders
FWD_ATOL = 1e-5
# gradients: relative to each entry, plus an absolute floor of 1e-6 of the
# tensor's largest entry for entries that cancel to near 0
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-6


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = tiny_config(), port_tiny_config()
    tree = jax_head_tree(jcfg, seed=3)
    rng = np.random.default_rng(0)
    hw = jcfg.clip.grid ** 2
    feats = rng.standard_normal(
        (jcfg.head.num_blocks, 2, hw, jcfg.head.in_channels)).astype(
            np.float32)
    # fixed weights of a scalar objective over all three outputs
    w = [rng.standard_normal(s).astype(np.float32) for s in
         ((2, hw, jcfg.num_classes), (jcfg.head.decoder_layers, 2, hw, hw),
          (2, hw, hw))]
    return jcfg, pcfg, tree, feats, w


def _jax_outputs(tree, feats, cfg):
    fused = jhead.segformer_fuse(tree, feats, cfg.head)
    segs, seg_attn = jhead.decoder_forward(tree, fused, cfg.head)
    return fused, segs, seg_attn, jhead.feature_affinity(fused)


def _port_outputs(head, feats):
    fused = phead.segformer_fuse(head, feats)
    segs, seg_attn = phead.decoder_forward(head, fused)
    return fused, segs, seg_attn, phead.feature_affinity(fused)


def test_head_forward_matches_jax(setup):
    jcfg, pcfg, tree, feats, _ = setup
    ref = _jax_outputs(jax.tree_util.tree_map(jnp.asarray, tree),
                       jnp.asarray(feats), jcfg)
    got = _port_outputs(port_head(tree, pcfg), t(feats))
    for name, g, r in zip(("fused", "segs", "seg_attn", "attn_pred"), got,
                          ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(n(g), np.asarray(r), atol=FWD_ATOL,
                                   err_msg=name)


def test_head_gradients_match_jax(setup):
    """The gradient of one scalar of all outputs (segs, the decoder's
    attention, attn_pred) with respect to every head parameter."""
    jcfg, pcfg, tree, feats, w = setup

    def objective(outs, w):
        _, segs, seg_attn, attn_pred = outs
        return ((segs * w[0]).sum() + (seg_attn * w[1]).sum()
                + (attn_pred * w[2]).sum())

    jgrads = jax.grad(lambda p: objective(
        _jax_outputs(p, jnp.asarray(feats), jcfg), w))(
            jax.tree_util.tree_map(jnp.asarray, tree))
    head = port_head(tree, pcfg)
    objective(_port_outputs(head, t(feats)), [t(a) for a in w]).backward()
    ref = port_head(jax.device_get(jgrads), pcfg).state_dict()
    for name, p in head.named_parameters():
        want = n(ref[name])
        np.testing.assert_allclose(
            n(p.grad), want, rtol=GRAD_RTOL,
            atol=GRAD_FLOOR * np.abs(want).max(), err_msg=name)


def test_parameter_names_mirror_the_jax_tree(setup):
    jcfg, pcfg, tree, _, _ = setup
    back = head_to_jax_tree(port_head(tree, pcfg))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_init_head_params_scales():
    """torch-default init: U(+-1/sqrt(fan_in)) for each linear weight and
    bias, LayerNorms at (1, 0); seeded draws repeat."""
    cfg = port_tiny_config()
    a = phead.init_head_params(cfg.head, cfg.num_classes,
                               torch.Generator().manual_seed(5), "cpu")
    b = phead.init_head_params(cfg.head, cfg.num_classes,
                               torch.Generator().manual_seed(5), "cpu")
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    w = a.fuse_mlps[0]["proj"]["w"].detach()
    bound = cfg.head.in_channels ** -0.5
    assert w.shape == (cfg.head.embedding_dim, cfg.head.in_channels)
    assert float(w.abs().max()) <= bound and float(w.std()) > bound / 3
    assert torch.equal(a.decoder[0]["ln_1"]["scale"],
                       torch.ones(cfg.head.embedding_dim))


def test_dropout2d_drops_whole_channels():
    """Each (sample, channel) is kept with probability 1 - rate over all
    tokens at once and scaled by 1 / (1 - rate). Keep rate within 4 sigma
    of 0.9 over 64 x 256 draws; the same generator seed repeats."""
    rate = 0.1
    x = torch.ones((64, 16, 256))
    y = phead.dropout2d(x, rate, torch.Generator().manual_seed(0))
    per_channel = y[:, 0, :]
    assert torch.equal(y, per_channel[:, None, :].expand_as(y))
    values = set(torch.unique(y).tolist())
    assert values <= {0.0, float(np.float32(1.0) / np.float32(0.9))}
    keep = float((per_channel > 0).float().mean())
    sigma = (rate * (1 - rate) / per_channel.numel()) ** 0.5
    assert abs(keep - (1 - rate)) <= 4 * sigma
    assert torch.equal(y, phead.dropout2d(x, rate,
                                          torch.Generator().manual_seed(0)))
    # the fuse applies it only when a generator is given
    cfg = port_tiny_config()
    head = phead.init_head_params(cfg.head, cfg.num_classes, device="cpu")
    feats = torch.randn((cfg.head.num_blocks, 2, 16, cfg.head.in_channels),
                        generator=torch.Generator().manual_seed(1))
    plain = phead.segformer_fuse(head, feats, None, rate)
    dropped = phead.segformer_fuse(head, feats,
                                   torch.Generator().manual_seed(2), rate)
    kept = (dropped != 0).all(dim=1)                        # [B, C]
    assert not kept.all()
    np.testing.assert_allclose(n(dropped)[:, :, n(kept)[0]][0],
                               n(plain / (1 - rate))[:, :, n(kept)[0]][0],
                               rtol=1e-6)


def test_feature_affinity_mean_is_global():
    """attn_pred centres on the mean over the whole batch: a batch's first
    image scores differently alone than beside another image."""
    rng = np.random.default_rng(1)
    fused = rng.standard_normal((2, 9, 8)).astype(np.float32)
    both = n(phead.feature_affinity(t(fused)))[0]
    alone = n(phead.feature_affinity(t(fused[:1])))[0]
    assert not np.allclose(both, alone, atol=1e-3)
    np.testing.assert_allclose(
        n(phead.feature_affinity(t(fused))),
        np.asarray(jhead.feature_affinity(jnp.asarray(fused))), atol=1e-6)
