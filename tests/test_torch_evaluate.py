"""The slice end to end: the port's training-free LAM eval (hist step and
the bucketed run_lam_eval sweep) against the JAX package's on synthetic
VOC-layout samples at tiny-config size. The JAX encoder runs its Pallas
attention kernels in interpret mode; the port takes its plain versions."""
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
from torch_port_common import jax_clip_tree, n, port_params, t

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


def test_unported_modes_and_missing_gpu_raise(setup):
    _, pcfg, dataset, tree, text = setup
    params = {"clip": port_params(tree, pcfg.clip)}
    with pytest.raises(NotImplementedError):
        pev.run_lam_eval(params, dataset, t(text), pcfg, mode="trained",
                         device="cpu")
    with pytest.raises(NotImplementedError):
        pev.run_lam_eval(params, dataset, t(text), dataclasses.replace(
            pcfg, refine=dataclasses.replace(pcfg.refine, par_bf16=True)),
            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pev.run_lam_eval(params, dataset, t(text), pcfg)
