"""The eval paths end to end: the port's training-free and trained LAM
eval (hist step and the bucketed run_lam_eval sweep) and its in-training
validation (val_hist_step, run_validation) against the JAX package's on
synthetic VOC-layout samples at tiny-config size. The JAX encoder runs its
Pallas attention kernels in interpret mode; the port takes its plain
versions."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from excel_tpu.config import tiny_config
from excel_tpu.data import EvalDataset, VocDataset
from excel_tpu.data.synthetic import make_voc_tree
from excel_tpu.engine import evaluate as jev
from excel_tpu.utils.metrics import init_hist as jax_init_hist
from excel_tpu_torch.config import tiny_config as port_tiny_config
from excel_tpu_torch.engine import evaluate as pev
from excel_tpu_torch.utils.metrics import init_hist
from torch_port_common import (jax_clip_tree, jax_head_tree, n, port_head,
                               port_params, t)

# Both sides see identical inputs, but SVC's uint8 truncation can turn a
# 1-ulp LAM difference into a different box. Observed: equal hists. Stated
# bound: at most this many pixels change class (0.1% of a 2-image batch).
MAX_DIFFERING_PIXELS = 20


def _cfgs():
    over = dict(eval_pad=96)
    jcfg = tiny_config()
    jcfg = dataclasses.replace(
        jcfg, clip=dataclasses.replace(jcfg.clip, fused_attention="interpret"),
        data=dataclasses.replace(jcfg.data, **over))
    pcfg = port_tiny_config()
    pcfg = dataclasses.replace(pcfg,
                               data=dataclasses.replace(pcfg.data, **over))
    return jcfg, pcfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, pcfg = _cfgs()
    root = str(tmp_path_factory.mktemp("voc"))
    split_dir = make_voc_tree(root, num_images=6, seed=0,
                              num_fg=jcfg.num_fg, size_range=(48, 96))
    base = VocDataset(root, split_dir, "val", "val")
    base.num_fg = jcfg.num_fg
    dataset = EvalDataset(base)
    tree = jax_clip_tree(jcfg.clip, seed=0)
    text = np.random.default_rng(0).normal(
        size=(jcfg.num_fg + 3, jcfg.clip.embed_dim)).astype(np.float32)
    return jcfg, pcfg, dataset, tree, text


@pytest.fixture(scope="module")
def trained(setup):
    """(JAX params, port params) with a seeded head."""
    jcfg, pcfg, _, tree, _ = setup
    head = jax_head_tree(jcfg, seed=1)
    return ({"clip": tree, "head": head},
            {"clip": port_params(tree, pcfg.clip),
             "head": port_head(head, pcfg)})


def _differing_pixels(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
               .sum()) // 2


def test_lam_eval_hist_step_matches(setup):
    jcfg, pcfg, dataset, tree, text = setup
    canvas, samples = next(pev._bucketed_batches(
        dataset, 2, pcfg.data.eval_pad, pcfg.refine.slot_buckets,
        pcfg.num_fg))
    images, cls, labels, valid = pev._prep_batch(samples, 64, canvas)
    slots = pev._slots_bucket(cls, pcfg.num_fg, pcfg.refine.slot_buckets)
    jh = jev.lam_eval_hist_step(
        jax_init_hist(jcfg.num_classes), {"clip": tree}, jnp.asarray(images),
        jnp.asarray(cls), jnp.asarray(labels), jnp.asarray(valid),
        jnp.asarray(text), jcfg, canvas, class_slots=slots)
    ph = pev.lam_eval_hist_step(
        init_hist(pcfg.num_classes), {"clip": port_params(tree, pcfg.clip)},
        t(images), t(cls), t(labels), t(valid), t(text), pcfg, canvas,
        class_slots=slots)
    assert int(n(ph).sum()) == int((labels != 255).sum())
    assert _differing_pixels(n(ph), jh) <= MAX_DIFFERING_PIXELS


def test_run_lam_eval_sweep_matches(setup, monkeypatch):
    """The whole bucketed sweep (6 samples, batch 2, padded remainders);
    both sides return their final hist instead of scores."""
    jcfg, pcfg, dataset, tree, text = setup
    monkeypatch.setattr(jev, "scores_from_hist", np.asarray)
    monkeypatch.setattr(pev, "scores_from_hist", n)
    ref = jev.run_lam_eval({"clip": tree}, dataset, jnp.asarray(text), jcfg,
                           batch_size=2)
    got = pev.run_lam_eval({"clip": port_params(tree, pcfg.clip)}, dataset,
                           t(text), pcfg, batch_size=2, device="cpu")
    total = sum(int((dataset[i]["label"] != 255).sum())
                for i in range(len(dataset)))
    assert int(got.sum()) == int(ref.sum()) == total
    assert _differing_pixels(got, ref) <= MAX_DIFFERING_PIXELS


def test_run_lam_eval_resumes_from_checkpoint(setup, tmp_path):
    """A checkpoint written after the first batch is picked up by a rerun
    with the same protocol (and removed at the end of the sweep)."""
    _, pcfg, dataset, tree, text = setup
    params = {"clip": port_params(tree, pcfg.clip)}
    full = pev.run_lam_eval(params, dataset, t(text), pcfg, batch_size=2,
                            device="cpu")
    ckpt = str(tmp_path / "hist.npz")
    fp = (f"lam:sg1:{len(dataset)}:2:training_free:64:{pcfg.num_classes}:"
          f"{pcfg.data.eval_pad}:proc0/1")
    # a checkpoint claiming one batch done with an empty hist: the resumed
    # sweep skips that batch, so its pixel total drops by that batch's
    hist, _ = pev._sweep_resume(None, fp, pcfg.num_classes, "cpu")
    pev._sweep_save(ckpt, hist, 1, fp)
    resumed = pev.run_lam_eval(params, dataset, t(text), pcfg, batch_size=2,
                               checkpoint_path=ckpt, device="cpu")
    assert resumed["pAcc"] != full["pAcc"] or resumed["miou"] != full["miou"]
    assert not os.path.exists(ckpt)


def test_unported_modes_and_missing_gpu_raise(setup, trained, single_class):
    _, pcfg, dataset, tree, text = setup
    params = {"clip": port_params(tree, pcfg.clip)}
    # the trained mode is ported (held against JAX in
    # test_run_lam_eval_trained_matches): it runs on the
    # CPU when asked, and needs the head
    scores = pev.run_lam_eval(trained[1], single_class[:2], t(text), pcfg,
                              mode="trained", batch_size=2, device="cpu")
    assert 0.0 <= scores["miou"] <= 1.0
    with pytest.raises(KeyError):
        pev.run_lam_eval(params, dataset, t(text), pcfg, mode="trained",
                         device="cpu")
    # bf16 PAR at the tiny config's pad of 2 runs too (the per-step route;
    # held against JAX in tests/test_torch_fast.py)
    bf16_par = pev.run_lam_eval(params, dataset, t(text), dataclasses.replace(
        pcfg, refine=dataclasses.replace(pcfg.refine, par_bf16=True)),
        device="cpu")
    assert 0.0 <= bf16_par["miou"] <= 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pev.run_lam_eval(params, dataset, t(text), pcfg)


def test_val_hist_step_matches(setup, trained):
    """In-training validation of one batch: the pseudo-label hist (at the
    validation caa threshold, attn_pred as seg_attn) and the head's
    segmentation hist."""
    jcfg, pcfg, dataset, _, text = setup
    jparams, pparams = trained
    canvas, samples = next(pev._bucketed_batches(
        dataset, 2, pcfg.data.eval_pad, pcfg.refine.slot_buckets,
        pcfg.num_fg))
    images, cls, labels, valid = pev._prep_batch(samples, 64, canvas)
    slots = pev._slots_bucket(cls, pcfg.num_fg, pcfg.refine.slot_buckets)
    jp, js = jev.val_hist_step(
        jax_init_hist(jcfg.num_classes), jax_init_hist(jcfg.num_classes),
        jparams, jnp.asarray(images), jnp.asarray(cls), jnp.asarray(labels),
        jnp.asarray(valid), jnp.asarray(text), jcfg, canvas,
        class_slots=slots)
    pp, ps = pev.val_hist_step(
        init_hist(pcfg.num_classes), init_hist(pcfg.num_classes), pparams,
        t(images), t(cls), t(labels), t(valid), t(text), pcfg, canvas,
        class_slots=slots)
    total = int((labels != 255).sum())
    for got, ref in ((pp, jp), (ps, js)):
        assert int(n(got).sum()) == total
        assert _differing_pixels(n(got), ref) <= MAX_DIFFERING_PIXELS


def _sweep_pair(monkeypatch, run_jax, run_port):
    """Both sides' sweeps, returning their final hists instead of
    scores."""
    monkeypatch.setattr(jev, "scores_from_hist", np.asarray)
    monkeypatch.setattr(pev, "scores_from_hist", n)
    return run_jax(), run_port()


def _assert_hists_match(got, ref, dataset):
    total = sum(int((dataset[i]["label"] != 255).sum())
                for i in range(len(dataset)))
    assert int(got.sum()) == int(ref.sum()) == total
    assert _differing_pixels(got, ref) <= MAX_DIFFERING_PIXELS


def test_run_validation_matches(setup, trained, monkeypatch):
    """run_validation over the whole bucketed sweep (6 samples, batch 2):
    the pseudo-label hist and the seg hist."""
    jcfg, pcfg, dataset, _, text = setup
    jparams, pparams = trained
    refs, gots = _sweep_pair(
        monkeypatch,
        lambda: jev.run_validation(jparams, dataset, jnp.asarray(text), jcfg,
                                   batch_size=2),
        lambda: pev.run_validation(pparams, dataset, t(text), pcfg,
                                   batch_size=2, device="cpu"))
    for got, ref in zip(gots, refs):
        _assert_hists_match(got, ref, dataset)


@pytest.fixture(scope="module")
def single_class(tmp_path_factory):
    """Four synthetic samples of one class each. With two or more classes
    the trained mode's flip-fused maps of a random-weight model reach their
    maximum in the same cells for both classes and tie over whole regions,
    where an ulp upstream decides the label (observed: 298 pixels moved on
    the 6-sample multi-class set)."""
    root = str(tmp_path_factory.mktemp("voc1"))
    split_dir = make_voc_tree(root, num_images=12, seed=1,
                              num_fg=tiny_config().num_fg,
                              size_range=(48, 96))
    base = VocDataset(root, split_dir, "val", "val")
    base.num_fg = tiny_config().num_fg
    dataset = EvalDataset(base)
    return [dataset[i] for i in range(len(dataset))
            if dataset[i]["cls_label"].sum() == 1][:4]


def test_run_lam_eval_trained_matches(setup, trained, single_class,
                                      monkeypatch):
    """run_lam_eval(mode="trained") over a bucketed sweep (batch 2)."""
    jcfg, pcfg, _, _, text = setup
    jparams, pparams = trained
    ref, got = _sweep_pair(
        monkeypatch,
        lambda: jev.run_lam_eval(jparams, single_class, jnp.asarray(text),
                                 jcfg, mode="trained", batch_size=2),
        lambda: pev.run_lam_eval(pparams, single_class, t(text), pcfg,
                                 mode="trained", batch_size=2, device="cpu"))
    _assert_hists_match(got, ref, single_class)
