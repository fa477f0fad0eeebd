"""Training convergence of the port (counterpart of tests/test_convergence.py):
on a synthetic mini-dataset the LVC head must learn to reproduce its
pseudo-label targets.

- Tier-1: the JAX test's `test_seg_loss_converges` protocol at tiny_config
  with the head's dropout at 0, run by both packages on the same tree, the
  same batch stream (each package's `train_batches`, which yield the same
  crops), the same weights and text bank: for the first 12 steps the
  port's seg losses equal JAX's. The pseudo-labels are an argmax on random
  weights: where class maps tie over a region an ulp upstream decides it
  (here one image of step 5 differs on ~640 of 4,096 pixels, and the JAX
  package's own two routes, XLA and its Pallas kernels in interpret mode,
  differ on 688 there). As in tests/test_torch_train.py each step's
  pseudo-labels of the port are counted against the JAX step's own, and
  both steps then go on from the JAX step's labels, so that the losses,
  gradients and updates compare on the same targets. Without that replay
  the tied pixels alone move the seg loss by up to 3.3e-3 of itself.
- slow: both JAX tests whole, ported: their step counts, schedules and
  thresholds, the port's own seeded weights and dropout draws."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from excel_tpu.config import tiny_config
from excel_tpu.data import ClsCropDataset as JaxCropDataset
from excel_tpu.data import VocDataset as JaxVocDataset
from excel_tpu.data import train_batches as jax_train_batches
from excel_tpu.engine import train as jtr
from excel_tpu.models.excel import init_excel_params as jax_init_excel_params
from excel_tpu.models.params import init_clip_params as jax_init_clip_params
from excel_tpu_torch.config import tiny_config as port_tiny_config
from excel_tpu_torch.data.datasets import (ClsCropDataset, EvalDataset,
                                           VocDataset)
from excel_tpu_torch.data.loader import train_batches
from excel_tpu_torch.data.synthetic import make_voc_tree
from excel_tpu_torch.engine import train as ptr
from excel_tpu_torch.engine.evaluate import run_msc_seg_eval
from excel_tpu_torch.models.excel import init_excel_params
from excel_tpu_torch.models.params import init_clip_params
from torch_port_common import LABEL_DIFF_SHARE, port_head, port_params

PARITY_STEPS = 12
# the seg loss of a step on the same targets: fp32 sums taken in another
# order (observed within 2.4e-6 of itself)
SEG_LOSS_RTOL = 1e-4


def _schedule(cfg, **train):
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, **train))


def _tree(tmp_path, cfg, size_range):
    root = str(tmp_path)
    split_dir = make_voc_tree(root, num_images=4, seed=0, num_fg=cfg.num_fg,
                              size_range=size_range)
    return root, split_dir


def _crops(cls_voc, cls_crop, root, split_dir, cfg):
    base = cls_voc(root, split_dir, "train_aug", "train")
    base.num_fg = cfg.num_fg
    return cls_crop(base, crop_size=cfg.data.crop_size)


def _text_bank(cfg) -> np.ndarray:
    return np.random.default_rng(0).normal(
        size=(cfg.num_fg + 3, cfg.clip.embed_dim)).astype(np.float32)


def test_seg_losses_match_jax_for_12_steps(tmp_path):
    """The first 12 steps of `test_seg_loss_converges` in both packages,
    dropout off."""
    cfgs = []
    for cfg in (tiny_config(), port_tiny_config()):
        cfg = _schedule(cfg, max_iters=400, warmup_iters=5, lr=5e-4)
        cfgs.append(dataclasses.replace(cfg, head=dataclasses.replace(
            cfg.head, dropout=0.0)))
    jcfg, pcfg = cfgs
    root, split_dir = _tree(tmp_path, pcfg, (64, 96))
    jds = _crops(JaxVocDataset, JaxCropDataset, root, split_dir, jcfg)
    pds = _crops(VocDataset, ClsCropDataset, root, split_dir, pcfg)

    key = jax.random.PRNGKey(0)
    clip = jax_init_clip_params(key, jcfg.clip)
    params = jax_init_excel_params(key, jcfg, clip)
    jstate = jtr.init_train_state(params["head"], jcfg.train)
    pclip = port_params(jax.device_get(clip), pcfg.clip)
    pstate = ptr.init_train_state(
        port_head(jax.device_get(params["head"]), pcfg), pcfg.train)
    text = _text_bank(jcfg)

    recorded, differing = [], []
    jax_pseudo, port_pseudo = jtr.pseudo_labels, ptr.pseudo_labels

    def record(*args, **kwargs):
        out = jax_pseudo(*args, **kwargs)
        jax.debug.callback(lambda x: recorded.append(np.asarray(x)), out)
        return out

    def replay(*args, **kwargs):
        own = port_pseudo(*args, **kwargs)
        ref = torch.from_numpy(recorded.pop().copy())
        differing.append(int((own != ref).sum()))
        return ref

    jax_losses, port_losses = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "pseudo_labels", record)
        mp.setattr(ptr, "pseudo_labels", replay)
        step = jtr.compiled_train_step(jcfg, calibrated=False,
                                       seg_affinity=False, donate=False)
        jb, pb = (jax_train_batches(jds, jcfg.train.batch_size, seed=0),
                  train_batches(pds, pcfg.train.batch_size, seed=0))
        for i in range(PARITY_STEPS):
            a, b = next(jb), next(pb)
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["cls_label"], b["cls_label"])
            cls = b["cls_label"].astype(np.float32)
            jstate, m = step(jstate, clip, jnp.asarray(a["image"]),
                             jnp.asarray(cls), jnp.asarray(text),
                             jax.random.PRNGKey(i))
            jax_losses.append(float(m["seg_loss"]))
            pstate, pm = ptr.train_step(
                pstate, pclip, torch.from_numpy(b["image"]),
                torch.from_numpy(cls), torch.from_numpy(text), None, pcfg,
                calibrated=False, seg_affinity=False)
            port_losses.append(float(pm["seg_loss"]))
        jb.close()
        pb.close()
    assert not recorded and len(differing) == PARITY_STEPS
    np.testing.assert_allclose(port_losses, jax_losses, rtol=SEG_LOSS_RTOL)
    pixels = PARITY_STEPS * pcfg.train.batch_size * pcfg.data.crop_size ** 2
    assert sum(differing) <= LABEL_DIFF_SHARE * pixels, differing
    assert pstate.step == PARITY_STEPS


def _port_setup(tmp_path, cfg, size_range):
    root, split_dir = _tree(tmp_path, cfg, size_range)
    ds = _crops(VocDataset, ClsCropDataset, root, split_dir, cfg)
    clip = init_clip_params(cfg.clip, torch.Generator().manual_seed(0),
                            device="cpu")
    params = init_excel_params(cfg, clip, torch.Generator().manual_seed(0),
                               device="cpu")
    return root, split_dir, ds, params


def _train(state, clip, ds, text, cfg, steps, losses=None):
    batches = train_batches(ds, cfg.train.batch_size, seed=0)
    for i in range(steps):
        b = next(batches)
        state, m = ptr.train_step(
            state, clip, torch.from_numpy(b["image"]),
            torch.from_numpy(b["cls_label"].astype(np.float32)), text,
            ptr.step_generator(cfg.train, i, "cpu"), cfg, calibrated=False,
            seg_affinity=False)
        if losses is not None:
            losses.append(float(m["seg_loss"]))
    batches.close()
    return state


@pytest.mark.slow
def test_seg_loss_converges(tmp_path):
    cfg = port_tiny_config()
    # tiny preset's max_iters=10 poly-decays the LR to zero immediately;
    # give the schedule room for a real convergence check
    cfg = _schedule(cfg, max_iters=400, warmup_iters=5, lr=5e-4)
    _, _, ds, params = _port_setup(tmp_path, cfg, (64, 96))
    state = ptr.init_train_state(params["head"], cfg.train)
    losses = []
    _train(state, params["clip"], ds, torch.from_numpy(_text_bank(cfg)), cfg,
           40, losses)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert np.isfinite(losses).all()
    # random frozen features bound how well pseudo-labels can be fit; a
    # steady >20% drop demonstrates the optimizer/loss plumbing learns
    assert last < 0.8 * first, (first, last)
    # and the trend is genuinely downward, not noise
    corr = np.corrcoef(np.arange(len(losses)), losses)[0, 1]
    assert corr < -0.3, corr


@pytest.mark.slow
def test_trained_head_beats_random_init_miou(tmp_path):
    """After 60 head iterations on a synthetic tree the full eval path
    (run_msc_seg_eval -> hist -> scores) scores materially above the
    random-init head on the same scenes."""
    cfg = port_tiny_config()
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, eval_pad=160),
        train=dataclasses.replace(cfg.train, max_iters=200, warmup_iters=5,
                                  lr=5e-4))
    root, split_dir, ds, params = _port_setup(tmp_path, cfg, (100, 150))
    vbase = VocDataset(root, split_dir, "val", "val")
    vbase.num_fg = cfg.num_fg
    eval_ds = EvalDataset(vbase)
    text = torch.from_numpy(_text_bank(cfg))

    def miou():
        return run_msc_seg_eval(params, eval_ds, text, cfg, scales=(1.0,),
                                batch_size=2, device="cpu")["miou"]

    base_miou = miou()
    state = ptr.init_train_state(params["head"], cfg.train)
    _train(state, params["clip"], ds, text, cfg, 60)
    assert state.head is params["head"]          # trained in place
    trained_miou = miou()
    assert trained_miou > base_miou + 0.05, (base_miou, trained_miou)
