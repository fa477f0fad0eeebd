"""The final evaluation end to end: the port's MSC+flip segmentation eval
(grid logits, one scale's accumulation, the fused hist step, the bucketed
`run_msc_seg_eval` sweep with dumps and resume) and the on-device CRF
branches of both sweeps (`lam_crf_refine`, `lam_crf_hist_step`,
`run_lam_eval(crf_tpu=True)`, the `save_cam` / `save_lam_crf` dumps)
against the JAX package's, on synthetic VOC-layout samples at tiny-config
size with one seeded CLIP + head tree. The JAX encoder runs its Pallas
attention kernels in interpret mode and its CRF the XLA message loop (its
route on the CPU); the port takes its plain versions.

Scales (1.0, 0.75, 1.25) of the 64-px tiny config give 64, 48 and 80 px
(grids 4, 3 and 5 from a pretrained 2 x 2 table)."""
import dataclasses
import os

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
from torch_port_common import (jax_clip_tree, jax_head_tree,
                               jax_interpret_cfg, n, port_head, port_params,
                               t)

SCALES = (1.0, 0.75, 1.25)
# decoder logits of O(1) through the encoder, the head and two linear
# resizes, fp32 sums in other orders (observed 2e-6)
ATOL_LOGITS = 1e-4
# identical inputs on both sides, but an argmax over near-tied logits (or
# CRF marginals) can turn on an ulp. Observed: equal hists. Stated bound: at
# most this many pixels change class (0.1% of a 2-image batch)
MAX_DIFFERING_PIXELS = 20
# the dumped pre-PAR maps, min-max normalised to [0, 1]: the encoder's and
# SVC's fp32 sums (other orders) pass through a division by each map's
# range (observed 2.8e-5)
ATOL_CAMS = 1e-4


def _with_pad(cfg):
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                             eval_pad=96))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = _with_pad(jax_interpret_cfg(tiny_config()))
    pcfg = _with_pad(port_tiny_config())
    root = str(tmp_path_factory.mktemp("voc"))
    split_dir = make_voc_tree(root, num_images=5, seed=0,
                              num_fg=jcfg.num_fg, size_range=(48, 96))
    base = VocDataset(root, split_dir, "val", "val")
    base.num_fg = jcfg.num_fg
    dataset = EvalDataset(base)
    tree = jax_clip_tree(jcfg.clip, seed=0)
    head = jax_head_tree(jcfg, seed=1)
    text = np.random.default_rng(0).normal(
        size=(jcfg.num_fg + 3, jcfg.clip.embed_dim)).astype(np.float32)
    jparams = {"clip": tree, "head": head}
    pparams = {"clip": port_params(tree, pcfg.clip),
               "head": port_head(head, pcfg)}
    return jcfg, pcfg, dataset, jparams, pparams, text


@pytest.fixture(scope="module")
def batch(setup):
    """The first canvas bucket's batch of 2, prepared for MSC with the
    canvas-resolution images."""
    _, pcfg, dataset, _, _, _ = setup
    canvas, samples = next(pev._bucketed_batches(dataset, 2,
                                                 pcfg.data.eval_pad))
    prep, scale_images = pev._prep_msc_batch(samples, 64, canvas, SCALES,
                                             with_canvas_images=True)
    return canvas, samples, prep, scale_images


def _size_cfgs(cfg):
    return tuple(dataclasses.replace(cfg, clip=dataclasses.replace(
        cfg.clip, image_size=int(64 * sc))) for sc in SCALES)


def test_scale_cfgs(setup):
    _, pcfg, _, _, _, _ = setup
    assert pev._scale_cfgs(pcfg, 64, SCALES) == _size_cfgs(pcfg)
    assert [c.clip.tokens for c in pev._scale_cfgs(pcfg, 64, SCALES)] == [
        17, 10, 26]


def _differing_pixels(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
               .sum()) // 2


def test_prep_batch_with_canvas_images_matches(batch):
    canvas, samples, prep, scale_images = batch
    ref = jev._prep_batch(samples, 64, canvas, with_canvas_images=True)
    assert len(prep) == len(ref) == 5
    for got, want in zip(prep, ref):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert prep[4].shape == (2, *canvas, 3) and prep[4].dtype == np.uint8
    assert [x.shape for x in scale_images] == [
        (2, s, s, 3) for s in (64, 48, 80)]


@pytest.mark.parametrize("scale", SCALES)
def test_seg_grid_logits_matches(setup, batch, scale):
    jcfg, pcfg, _, jparams, pparams, text = setup
    i = SCALES.index(scale)
    images = batch[3][i]
    ref = jev.seg_grid_logits(jparams, jnp.asarray(images), jnp.asarray(text),
                              _size_cfgs(jcfg)[i])
    got = pev.seg_grid_logits(pparams, t(images), t(text),
                              _size_cfgs(pcfg)[i])
    side = int(64 * scale) // 16
    assert got.shape == (2, pcfg.num_classes, side, side)
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=ATOL_LOGITS,
                               rtol=0)


@pytest.mark.parametrize("keep_flip", [True, False])
def test_msc_accumulate_matches(setup, batch, keep_flip):
    """One scale (1.25) onto a non-zero accumulator, with the flip fused in
    and without."""
    jcfg, pcfg, _, jparams, pparams, text = setup
    canvas, _, prep, scale_images = batch
    images, valid = scale_images[2], prep[3]
    acc = np.random.default_rng(1).standard_normal(
        (2, pcfg.num_classes, *canvas)).astype(np.float32)
    ref = jev.msc_accumulate(jparams, jnp.asarray(images), jnp.asarray(valid),
                             jnp.asarray(text), _size_cfgs(jcfg)[2], canvas,
                             jnp.asarray(acc), keep_flip=keep_flip)
    got = pev.msc_accumulate(pparams, t(images), t(valid), t(text),
                             _size_cfgs(pcfg)[2], canvas, t(acc),
                             keep_flip=keep_flip)
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=ATOL_LOGITS,
                               rtol=0)
    # beyond each image's valid extent nothing is added
    h, w = valid[1]
    np.testing.assert_array_equal(n(got)[1, :, h:, :], acc[1, :, h:, :])
    np.testing.assert_array_equal(n(got)[1, :, :, w:], acc[1, :, :, w:])


@pytest.mark.parametrize("use_crf", [False, True])
def test_msc_hist_step_matches(setup, batch, use_crf):
    """All scales + flip + (CRF) + argmax + hist with the outputs returned:
    the logits are the pre-CRF sums either way."""
    jcfg, pcfg, _, jparams, pparams, text = setup
    canvas, _, prep, scale_images = batch
    _, _, labels, valid, canvas_images = prep
    keep = tuple(sc != 1.0 for sc in SCALES)
    jh, jl, jp = jev.msc_hist_step(
        jax_init_hist(jcfg.num_classes), jparams,
        tuple(jnp.asarray(x) for x in scale_images),
        jnp.asarray(labels), jnp.asarray(valid), jnp.asarray(text),
        _size_cfgs(jcfg), canvas, keep,
        canvas_images=jnp.asarray(canvas_images), use_crf=use_crf,
        return_outputs=True)
    ph, pl, pp = pev.msc_hist_step(
        init_hist(pcfg.num_classes), pparams,
        tuple(t(x) for x in scale_images), t(labels), t(valid),
        t(text), _size_cfgs(pcfg), canvas, keep,
        canvas_images=t(canvas_images), use_crf=use_crf, return_outputs=True)
    np.testing.assert_allclose(n(pl), np.asarray(jl), atol=ATOL_LOGITS,
                               rtol=0)
    mask = labels != 255
    assert pp.dtype == torch.int32
    assert int((n(pp) != np.asarray(jp))[mask].sum()) <= MAX_DIFFERING_PIXELS
    assert int(n(ph).sum()) == int(mask.sum())
    assert _differing_pixels(n(ph), jh) <= MAX_DIFFERING_PIXELS
    if use_crf:
        plain = pev.msc_hist_step(
            init_hist(pcfg.num_classes), pparams,
            tuple(t(x) for x in scale_images), t(labels), t(valid),
            t(text), _size_cfgs(pcfg), canvas, keep, return_outputs=True)
        assert torch.equal(plain[1], pl)          # the same pre-CRF logits
        assert not torch.equal(plain[2], pp)      # the CRF moved the argmax


@pytest.mark.parametrize("crf_tpu", [False, True])
def test_run_msc_seg_eval_matches(setup, monkeypatch, crf_tpu):
    """The bucketed sweep (5 samples, batch 2, a padded remainder); both
    sides return their final hist instead of scores."""
    jcfg, pcfg, dataset, jparams, pparams, text = setup
    monkeypatch.setattr(jev, "scores_from_hist", np.asarray)
    monkeypatch.setattr(pev, "scores_from_hist", n)
    ref = jev.run_msc_seg_eval(jparams, dataset, jnp.asarray(text), jcfg,
                               scales=SCALES, batch_size=2, crf_tpu=crf_tpu)
    got = pev.run_msc_seg_eval(pparams, dataset, t(text), pcfg, scales=SCALES,
                               batch_size=2, crf_tpu=crf_tpu, device="cpu")
    total = sum(int((dataset[i]["label"] != 255).sum())
                for i in range(len(dataset)))
    assert int(got.sum()) == int(ref.sum()) == total
    assert _differing_pixels(got, ref) <= MAX_DIFFERING_PIXELS


def test_run_msc_seg_eval_scores_and_device(setup):
    _, pcfg, dataset, _, pparams, text = setup
    scores = pev.run_msc_seg_eval(pparams, dataset, t(text), pcfg,
                                  scales=(1.0,), batch_size=2, device="cpu")
    assert 0.0 <= scores["miou"] <= 1.0
    assert len(scores["iou"]) == pcfg.num_classes
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pev.run_msc_seg_eval(pparams, dataset, t(text), pcfg)


def test_msc_dumps_are_pre_crf_and_averaged(setup, batch):
    """save_logits receives the fused logits averaged over the scales,
    pre-CRF whether or not the CRF runs; save_pred the (post-CRF) argmax;
    one emission per dataset image, the remainder's blanks skipped; and a
    dump sweep scores as the hist-only sweep."""
    _, pcfg, dataset, _, pparams, text = setup
    names = sorted(dataset[i]["name"] for i in range(len(dataset)))
    dumps = {}
    for crf in (False, True):
        logits, preds, calls = {}, {}, []
        scores = pev.run_msc_seg_eval(
            pparams, dataset, t(text), pcfg, scales=SCALES, batch_size=2,
            crf_tpu=crf, device="cpu",
            save_logits=lambda k, v: (calls.append(k),
                                      logits.__setitem__(k, v)),
            save_pred=lambda k, v: preds.__setitem__(k, v))
        assert sorted(calls) == names and sorted(preds) == names
        dumps[crf] = (logits, preds, scores)
    raw_logits, raw_preds, raw_scores = dumps[False]
    crf_logits, crf_preds, _ = dumps[True]
    for i in range(len(dataset)):
        s = dataset[i]
        k = s["name"]
        assert raw_logits[k].shape == (pcfg.num_classes, *s["label"].shape)
        assert raw_preds[k].shape == s["label"].shape
        np.testing.assert_array_equal(raw_logits[k], crf_logits[k])
        np.testing.assert_array_equal(raw_preds[k], raw_logits[k].argmax(0))
    assert any((raw_preds[k] != crf_preds[k]).any() for k in names)
    # divided by the number of scales: the first batch's step output / 3
    canvas, samples, prep, scale_images = batch
    _, summed, _ = pev.msc_hist_step(
        init_hist(pcfg.num_classes), pparams,
        tuple(t(x) for x in scale_images), t(prep[2]), t(prep[3]),
        t(text), _size_cfgs(pcfg), canvas, tuple(sc != 1.0 for sc in SCALES),
        return_outputs=True)
    h, w = samples[0]["label"].shape
    np.testing.assert_array_equal(raw_logits[samples[0]["name"]],
                                  n(summed)[0, :, :h, :w] / len(SCALES))
    plain = pev.run_msc_seg_eval(pparams, dataset, t(text), pcfg,
                                 scales=SCALES, batch_size=2, device="cpu")
    assert plain["miou"] == raw_scores["miou"]


def test_msc_sweep_resumes_and_a_changed_crf_restarts(setup, tmp_path,
                                                      monkeypatch):
    """A sweep killed after its second checkpoint resumes to the same hist;
    with another CRF parameter the fingerprint differs and the sweep starts
    over (same hist as an unresumed run under that parameter)."""
    _, pcfg, dataset, _, pparams, text = setup
    monkeypatch.setattr(pev, "scores_from_hist", n)
    kw = dict(scales=(1.0, 0.75), batch_size=1, crf_tpu=True, device="cpu")
    cfg = dataclasses.replace(pcfg, crf=dataclasses.replace(pcfg.crf,
                                                            iters=2))
    full = pev.run_msc_seg_eval(pparams, dataset, t(text), cfg, **kw)
    ckpt = str(tmp_path / "msc_hist.npz")
    save, saves = pev._sweep_save, []

    def save_then_kill(*args):
        save(*args)
        saves.append(args[2])
        if len(saves) == 2:
            raise KeyboardInterrupt

    monkeypatch.setattr(pev, "_sweep_save", save_then_kill)
    with pytest.raises(KeyboardInterrupt):
        pev.run_msc_seg_eval(pparams, dataset, t(text), cfg,
                             checkpoint_path=ckpt, checkpoint_every=1, **kw)
    monkeypatch.setattr(pev, "_sweep_save", save)
    assert saves == [1, 2] and os.path.exists(ckpt)
    with np.load(ckpt) as d:
        assert 0 < int(d["hist"].sum()) < int(full.sum())
    resumed = pev.run_msc_seg_eval(pparams, dataset, t(text), cfg,
                                   checkpoint_path=ckpt, **kw)
    np.testing.assert_array_equal(resumed, full)
    assert not os.path.exists(ckpt)           # removed when complete

    # a checkpoint of this protocol claiming two batches done with the
    # full hist: the same protocol takes it (its hist grows by the other
    # three batches), another CRF parameter ignores it and starts over
    fp = (f"msc:{len(dataset)}:1:64:{(1.0, 0.75)}:True:{cfg.crf}:"
          f"{pcfg.num_classes}:{pcfg.data.eval_pad}:proc0/1")
    save(ckpt, t(full), 2, fp)
    other = dataclasses.replace(cfg, crf=dataclasses.replace(cfg.crf,
                                                             bi_w=3.0))
    fresh = pev.run_msc_seg_eval(pparams, dataset, t(text), other, **kw)
    save(ckpt, t(full), 2, fp)
    restarted = pev.run_msc_seg_eval(pparams, dataset, t(text), other,
                                     checkpoint_path=ckpt, **kw)
    np.testing.assert_array_equal(restarted, fresh)
    save(ckpt, t(full), 2, fp)
    taken = pev.run_msc_seg_eval(pparams, dataset, t(text), cfg,
                                 checkpoint_path=ckpt, **kw)
    assert int(full.sum()) < int(taken.sum()) < 2 * int(full.sum())


# ---------------------------------------------------------------------------
# the CRF branch of the LAM sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("class_slots", [None, 2])
def test_lam_crf_refine_matches(setup, batch, class_slots):
    jcfg, pcfg, _, _, _, _ = setup
    canvas, _, prep, _ = batch
    _, cls, _, valid, canvas_images = prep
    rng = np.random.default_rng(2)
    channels = 1 + (class_slots or pcfg.num_fg)
    cams = rng.random((2, channels, *canvas), dtype=np.float32)
    ref = jev.lam_crf_refine(jnp.asarray(cams), jnp.asarray(canvas_images),
                             jnp.asarray(cls), jnp.asarray(valid), jcfg,
                             class_slots=class_slots)
    got = pev.lam_crf_refine(t(cams), t(canvas_images), t(cls), t(valid),
                             pcfg, class_slots=class_slots)
    assert got.dtype == torch.int32 and got.shape == (2, *canvas)
    assert int((n(got) != np.asarray(ref)).sum()) <= MAX_DIFFERING_PIXELS


def test_lam_crf_hist_step_matches(setup, batch):
    jcfg, pcfg, _, jparams, pparams, text = setup
    canvas, _, prep, scale_images = batch
    images = scale_images[0]
    _, cls, labels, valid, canvas_images = prep
    slots = pev._slots_bucket(cls, pcfg.num_fg, pcfg.refine.slot_buckets)
    jh, jc = jev.lam_crf_hist_step(
        jax_init_hist(jcfg.num_classes), jax_init_hist(jcfg.num_classes),
        jparams, jnp.asarray(images), jnp.asarray(cls), jnp.asarray(labels),
        jnp.asarray(valid), jnp.asarray(canvas_images), jnp.asarray(text),
        jcfg, canvas, class_slots=slots)
    ph, pc = pev.lam_crf_hist_step(
        init_hist(pcfg.num_classes), init_hist(pcfg.num_classes), pparams,
        t(images), t(cls), t(labels), t(valid), t(canvas_images), t(text),
        pcfg, canvas, class_slots=slots)
    total = int((labels != 255).sum())
    for got, ref in ((ph, jh), (pc, jc)):
        assert int(n(got).sum()) == total
        assert _differing_pixels(n(got), ref) <= MAX_DIFFERING_PIXELS
    assert not torch.equal(ph, pc)                # the CRF branch is live


def test_run_lam_eval_crf_tpu_matches(setup, monkeypatch):
    """run_lam_eval(crf_tpu=True) returns the pair (scores, crf_scores);
    both hists against the JAX package's, and the raw one equals the plain
    sweep's."""
    jcfg, pcfg, dataset, jparams, pparams, text = setup
    monkeypatch.setattr(jev, "scores_from_hist", np.asarray)
    monkeypatch.setattr(pev, "scores_from_hist", n)
    ref = jev.run_lam_eval(jparams, dataset, jnp.asarray(text), jcfg,
                           batch_size=2, crf_tpu=True)
    got = pev.run_lam_eval(pparams, dataset, t(text), pcfg, batch_size=2,
                           crf_tpu=True, device="cpu")
    assert isinstance(got, tuple) and len(got) == 2
    for g, r in zip(got, ref):
        assert int(g.sum()) == int(np.asarray(r).sum())
        assert _differing_pixels(g, r) <= MAX_DIFFERING_PIXELS
    plain = pev.run_lam_eval(pparams, dataset, t(text), pcfg, batch_size=2,
                             device="cpu")
    np.testing.assert_array_equal(plain, got[0])


@pytest.mark.parametrize("with_cam", [True, False])
def test_lam_dump_callbacks_match(setup, monkeypatch, with_cam):
    """save_cam (the full class stack) and save_lam_crf (bg +
    present classes with their fg indices; the compacted stack when no CAM
    dump forces the full one), with the CRF branch in the dump path: names,
    shapes, keys and values as the
    JAX package's, and the same scores as the hist-only CRF sweep."""
    jcfg, pcfg, dataset, jparams, pparams, text = setup
    monkeypatch.setattr(jev, "scores_from_hist", np.asarray)
    monkeypatch.setattr(pev, "scores_from_hist", n)
    out = {}
    for side, run, params, txt, cfg, kw in (
            ("jax", jev.run_lam_eval, jparams, jnp.asarray(text), jcfg, {}),
            ("port", pev.run_lam_eval, pparams, t(text), pcfg,
             dict(device="cpu"))):
        cams, spills = [], []
        hists = run(params, dataset, txt, cfg, batch_size=2, crf_tpu=True,
                    save_cam=((lambda k, im, c: cams.append((k, im, c)))
                              if with_cam else None),
                    save_lam_crf=lambda k, v, keys: spills.append(
                        (k, v, keys)), **kw)
        out[side] = (cams, spills, hists)
    (jcams, jspills, jh), (pcams, pspills, ph) = out["jax"], out["port"]
    assert [c[0] for c in pcams] == [c[0] for c in jcams]
    assert len(pspills) == len(dataset)
    if with_cam:      # every image once, no remainder blanks
        assert sorted(c[0] for c in pcams) == sorted(
            dataset[i]["name"] for i in range(len(dataset)))
    for (pk, pim, pc), (jk, jim, jc) in zip(pcams, jcams):
        np.testing.assert_array_equal(pim, jim)
        assert pc.shape == (1 + pcfg.num_fg, *pim.shape[:2])
        np.testing.assert_allclose(pc, jc, atol=ATOL_CAMS, rtol=0)
    jby = {k: (v, keys) for k, v, keys in jspills}
    for k, v, keys in pspills:
        jv, jkeys = jby[k]
        np.testing.assert_array_equal(keys, jkeys)
        assert v.shape == jv.shape and v.shape[0] == 1 + len(keys)
        np.testing.assert_allclose(v, jv, atol=ATOL_CAMS, rtol=0)
    for g, r in zip(ph, jh):
        assert _differing_pixels(g, r) <= MAX_DIFFERING_PIXELS
    if not with_cam:
        fused = pev.run_lam_eval(pparams, dataset, t(text), pcfg,
                                 batch_size=2, crf_tpu=True, device="cpu")
        for g, r in zip(ph, fused):
            np.testing.assert_array_equal(g, r)
