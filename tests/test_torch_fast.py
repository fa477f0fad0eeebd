"""The fast preset end to end: the port's training-free LAM eval under
`fast()` (bf16 encoder, bf16 PAR) against the JAX package's, with the JAX
encoder on its Pallas attention kernels and its PAR on its Pallas kernels,
both in interpret mode; the port takes its plain versions.

The tiny config's dilations (1, 2) give a pad of 2, where both packages
take the per-step bf16 route (sums rounded to bf16 between chunks; the last
test), so the other tests use dilations (1, 8) (pad 8, the padded Pallas
route) on a 128-px canvas (images 97-128 px, so every canvas is 128 x 128
and takes the fused pad-clamp kernel)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from excel_tpu.config import fast as jax_fast
from excel_tpu.config import tiny_config
from excel_tpu.data import EvalDataset, VocDataset
from excel_tpu.data.synthetic import make_voc_tree
from excel_tpu.engine import evaluate as jev
from excel_tpu.models.params import cast_matmul_weights as jax_cast
from excel_tpu.ops.par import par_refine as jax_par_refine
from excel_tpu.utils.metrics import init_hist as jax_init_hist
from excel_tpu_torch.config import fast
from excel_tpu_torch.config import tiny_config as port_tiny_config
from excel_tpu_torch.engine import evaluate as pev
from excel_tpu_torch.models.params import cast_matmul_weights
from excel_tpu_torch.utils.metrics import init_hist
from torch_port_common import jax_clip_tree, n, port_params, t

# bf16 rounds at more places than fp32, and the two sides round some of
# them differently: XLA fuses bf16 chains inside the eval step's jit and
# keeps fp32 between their ops, and the two GEMM libraries sum a product in
# different orders before rounding it to bf16 (the patch embedding differs
# by one bf16 ulp in about 0.05% of its outputs). The LAMs' min-max
# normalisation spreads such ulps over a whole map and SVC's uint8
# truncation can move a box, so labels differ in a small share of pixels.
# Observed: 0.73% of the valid pixels of the first batch. Bound: 2%.
MAX_DIFFERING_SHARE = 0.02


def _cfgs():
    over = dict(eval_pad=128)
    jcfg = jax_fast(tiny_config())
    jcfg = dataclasses.replace(
        jcfg, clip=dataclasses.replace(jcfg.clip, fused_attention="interpret"),
        refine=dataclasses.replace(jcfg.refine, par_dilations=(1, 8)),
        data=dataclasses.replace(jcfg.data, **over))
    pcfg = fast(port_tiny_config())
    pcfg = dataclasses.replace(
        pcfg, refine=dataclasses.replace(pcfg.refine, par_dilations=(1, 8)),
        data=dataclasses.replace(pcfg.data, **over))
    return jcfg, pcfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, pcfg = _cfgs()
    root = str(tmp_path_factory.mktemp("voc"))
    split_dir = make_voc_tree(root, num_images=4, seed=1,
                              num_fg=jcfg.num_fg, size_range=(97, 129))
    base = VocDataset(root, split_dir, "val", "val")
    base.num_fg = jcfg.num_fg
    dataset = EvalDataset(base)
    tree = jax_clip_tree(jcfg.clip, seed=0)
    text = np.random.default_rng(0).normal(
        size=(jcfg.num_fg + 3, jcfg.clip.embed_dim)).astype(np.float32)
    jparams = {"clip": jax_cast(tree, jnp.bfloat16)}
    pparams = {"clip": cast_matmul_weights(port_params(tree, pcfg.clip),
                                           torch.bfloat16)}
    return jcfg, pcfg, dataset, jparams, pparams, text


@pytest.fixture
def jax_par_on_pallas(monkeypatch):
    """JAX's eval calls par_refine with use_pallas on auto, which is False
    on the CPU: route it through the Pallas kernels (interpret mode)."""
    monkeypatch.setattr(jev, "par_refine", functools.partial(
        jax_par_refine, use_pallas="interpret"))
    jax.clear_caches()
    yield
    jax.clear_caches()


def _differing_pixels(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
               .sum()) // 2


def test_fast_lam_eval_step_matches(setup, jax_par_on_pallas):
    jcfg, pcfg, dataset, jparams, pparams, text = setup
    canvas, samples = next(pev._bucketed_batches(
        dataset, 2, pcfg.data.eval_pad, pcfg.refine.slot_buckets,
        pcfg.num_fg))
    assert canvas == (128, 128)
    images, cls, labels, valid = pev._prep_batch(samples, 64, canvas)
    slots = pev._slots_bucket(cls, pcfg.num_fg, pcfg.refine.slot_buckets)
    jl = jev.lam_eval_step(jparams, jnp.asarray(images), jnp.asarray(cls),
                           jnp.asarray(valid), jnp.asarray(text), jcfg,
                           canvas, class_slots=slots)
    pl = pev.lam_eval_step(pparams, t(images), t(cls), t(valid), t(text),
                           pcfg, canvas, class_slots=slots)
    mask = labels != 255
    share = float((n(pl) != np.asarray(jl))[mask].mean())
    assert share <= MAX_DIFFERING_SHARE, share
    jh = jev.lam_eval_hist_step(
        jax_init_hist(jcfg.num_classes), jparams, jnp.asarray(images),
        jnp.asarray(cls), jnp.asarray(labels), jnp.asarray(valid),
        jnp.asarray(text), jcfg, canvas, class_slots=slots)
    ph = pev.lam_eval_hist_step(
        init_hist(pcfg.num_classes), pparams, t(images), t(cls), t(labels),
        t(valid), t(text), pcfg, canvas, class_slots=slots)
    assert int(n(ph).sum()) == int(mask.sum())
    assert (_differing_pixels(n(ph), jh)
            <= MAX_DIFFERING_SHARE * int(mask.sum()))


def test_fast_run_lam_eval_matches(setup, jax_par_on_pallas, monkeypatch):
    """The bucketed sweep (4 samples, batch 2); both sides return their
    final hist instead of scores."""
    jcfg, pcfg, dataset, jparams, pparams, text = setup
    monkeypatch.setattr(jev, "scores_from_hist", np.asarray)
    monkeypatch.setattr(pev, "scores_from_hist", n)
    ref = jev.run_lam_eval(jparams, dataset, jnp.asarray(text), jcfg,
                           batch_size=2)
    got = pev.run_lam_eval(pparams, dataset, t(text), pcfg, batch_size=2,
                           device="cpu")
    total = sum(int((dataset[i]["label"] != 255).sum())
                for i in range(len(dataset)))
    assert int(got.sum()) == int(ref.sum()) == total
    share = _differing_pixels(got, ref) / total
    assert share <= MAX_DIFFERING_SHARE, share


def test_fast_par_needs_a_pad_multiple_of_8(setup, jax_par_on_pallas,
                                            monkeypatch):
    """The fast preset's padded PAR kernels need a pad that is a multiple
    of 8; with the tiny config's own dilations (pad 2) the port takes the
    per-step bf16 route instead, as the JAX package's Pallas route does (its `_diffuse_kernel` with a bf16 output):
    the sweep against JAX's, within the fast preset's bound."""
    jcfg, pcfg, dataset, jparams, pparams, text = setup
    jcfg, pcfg = (dataclasses.replace(c, refine=dataclasses.replace(
        c.refine, par_dilations=(1, 2))) for c in (jcfg, pcfg))
    monkeypatch.setattr(jev, "scores_from_hist", np.asarray)
    monkeypatch.setattr(pev, "scores_from_hist", n)
    ref = jev.run_lam_eval(jparams, dataset, jnp.asarray(text), jcfg,
                           batch_size=2)
    got = pev.run_lam_eval(pparams, dataset, t(text), pcfg, batch_size=2,
                           device="cpu")
    total = sum(int((dataset[i]["label"] != 255).sum())
                for i in range(len(dataset)))
    assert int(got.sum()) == int(ref.sum()) == total
    share = _differing_pixels(got, ref) / total
    assert share <= MAX_DIFFERING_SHARE, share
