"""The port's crop-resolution pipelines (excel_tpu_torch.engine.pipeline)
against the JAX package's at tiny-config size on the CPU: the PAR guidance
of training (`denormalize_images`) on every byte value, `pseudo_labels`
from the same inputs, and `training_free_step` and `trained_lam_step` end
to end. The JAX encoder runs its Pallas attention kernels in interpret
mode.

The batches hold one class per image. With two, a random-weight model's
class maps peak in the same grid cells and tie within ~1e-6 over whole
patches, where an ulp upstream decides the label (tests/test_torch_train.py
bounds that case on the training step)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from excel_tpu.config import tiny_config
from excel_tpu.engine import pipeline as jpl
from excel_tpu.models.excel import excel_forward as jax_forward
from excel_tpu_torch.config import tiny_config as port_tiny_config
from excel_tpu_torch.engine import pipeline as ppl
from torch_port_common import (jax_clip_tree, jax_head_tree,
                               jax_interpret_cfg, n, port_head, port_params,
                               t, train_batch)

# labels that may differ: 0.1% of the 4 x 64 x 64 pixels (observed 0)
MAX_DIFFERING = 16
# fp32 seg logits through the encoder and the head
SEG_ATOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = jax_interpret_cfg(tiny_config()), port_tiny_config()
    clip = jax_clip_tree(jcfg.clip, seed=0)
    head = jax_head_tree(jcfg, seed=1)
    images, cls, text = train_batch(jcfg, 4, seed=1, max_classes=1)
    return (jcfg, pcfg, {"clip": clip, "head": head},
            {"clip": port_params(clip, pcfg.clip),
             "head": port_head(head, pcfg)}, images, cls, text)


def test_denormalize_images_exact_on_every_byte():
    """normalize then denormalize of the bytes 0-255 in each channel, bit
    for bit against the JAX package's compiled program (the train step's
    form: XLA makes both divisions products with reciprocals and fuses
    x * std + mean into one multiply-add). An ulp in x * std + mean moves
    a whole grey level: the JAX functions run op by op (true divisions, a
    separate product and sum) land on another level for some bytes, which
    the compiled program does not compute."""
    u8 = np.broadcast_to(np.arange(256, dtype=np.uint8)[None, :, None],
                         (1, 256, 3)).copy()
    normed = n(ppl.normalize_images(t(u8)))
    np.testing.assert_array_equal(
        normed, np.asarray(jax.jit(jpl.normalize_images)(jnp.asarray(u8))))
    got = n(ppl.denormalize_images(t(normed)))
    ref = np.asarray(jax.jit(lambda x: jpl.denormalize_images(
        jpl.normalize_images(x)))(jnp.asarray(u8)))
    np.testing.assert_array_equal(got, ref)
    assert set(np.round(got * 255).astype(int).ravel()) <= set(range(256))


def _differing(a, b) -> int:
    return int((np.asarray(a) != n(b)).sum())


@pytest.mark.parametrize("calibrated", [False, True])
def test_pseudo_labels_match_jax(setup, calibrated):
    """The same LAMs, attention stack, guidance and (calibrated) seg_attn
    into both packages' pseudo_labels (SVC, background, PAR at full extent,
    argmax), with and without class-slot compaction."""
    jcfg, pcfg, jparams, _, images, cls, text = setup
    im = jpl.normalize_images(jnp.asarray(images))
    out = jax_forward(jparams, im, jnp.asarray(text), jcfg)
    lams = out.lams
    if calibrated:
        lams = jax_forward(jparams, im, jnp.asarray(text), jcfg,
                           ex_feats=out.fused)
    guide = jpl.denormalize_images(im).transpose(0, 3, 1, 2)
    seg_attn = out.attn_pred if calibrated else None
    for slots in (None, 2):
        ref = jax.jit(lambda *a: jpl.pseudo_labels(
            *a, jcfg, (64, 64), jcfg.refine.caa_threshold, seg_attn=seg_attn,
            class_slots=slots))(lams, out.attn_weights, guide,
                                jnp.asarray(cls))
        got = ppl.pseudo_labels(
            t(lams), t(out.attn_weights), t(guide), t(cls), pcfg, (64, 64),
            pcfg.refine.caa_threshold,
            seg_attn=None if seg_attn is None else t(seg_attn),
            class_slots=slots)
        assert got.dtype == torch.int32 and got.shape == (4, 64, 64)
        assert _differing(ref, got) <= MAX_DIFFERING


def test_training_free_step_matches_jax(setup):
    jcfg, pcfg, jparams, pparams, images, cls, text = setup
    ref = jpl.training_free_step(jparams["clip"], jnp.asarray(images),
                                 jnp.asarray(cls), jnp.asarray(text), jcfg)
    got = ppl.training_free_step(pparams["clip"], t(images), t(cls), t(text),
                                 pcfg)
    assert _differing(ref, got) <= MAX_DIFFERING


@pytest.mark.parametrize("calibrated", [False, True])
def test_trained_lam_step_matches_jax(setup, calibrated):
    jcfg, pcfg, jparams, pparams, images, cls, text = setup
    ref_labels, ref_segs = jpl.trained_lam_step(
        jparams, jnp.asarray(images), jnp.asarray(cls), jnp.asarray(text),
        jcfg, calibrated=calibrated)
    labels, segs = ppl.trained_lam_step(pparams, t(images), t(cls), t(text),
                                        pcfg, calibrated=calibrated)
    assert _differing(ref_labels, labels) <= MAX_DIFFERING
    np.testing.assert_allclose(n(segs), np.asarray(ref_segs), atol=SEG_ATOL)
