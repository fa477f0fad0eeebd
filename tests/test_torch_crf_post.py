"""The port's host CRF post-pass (excel_tpu_torch.engine.crf_post) against
the JAX package's (excel_tpu.engine.crf_post) on one synthetic tree of 3
small images (48-96 px), 21 classes: the same hists from the same spill
directory, spills written by either package read by the other, the COCO
0.2-scale spill, the streamed pass equal to the post-pass, and the pool's
order and memory bound."""
import os
import threading
import time

import numpy as np
import pytest

from excel_tpu.config import CrfConfig as JaxCrfConfig
from excel_tpu.engine import crf_post as jpost
from excel_tpu_torch.config import CrfConfig
from excel_tpu_torch.data.datasets import EvalDataset, VocDataset
from excel_tpu_torch.data.synthetic import make_voc_tree
from excel_tpu_torch.engine import crf_post as ppost

NUM_CLASSES = 21


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("crf_tree"))
    split_dir = make_voc_tree(root, num_images=3, seed=0,
                              size_range=(48, 96))
    return EvalDataset(VocDataset(root, split_dir, "val", "val"))


def _seg_logits(dataset, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(len(dataset)):
        s = dataset[i]
        h, w = s["label"].shape
        logits = rng.normal(size=(NUM_CLASSES, h, w)).astype(np.float32)
        # the right class a little ahead, so the CRF has regions to keep
        logits[s["label"].clip(0, NUM_CLASSES - 1), *np.indices((h, w))] += 2
        out[s["name"]] = logits
    return out


def _lams(dataset, seed=1):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(len(dataset)):
        s = dataset[i]
        keys = np.flatnonzero(s["cls_label"])
        h, w = s["label"].shape
        lam = rng.random((1 + len(keys), h, w)).astype(np.float32)
        lam /= lam.sum(0, keepdims=True)
        out[s["name"]] = (lam, keys)
    return out


def _spill(tmp_path, dataset, package, kind, scale=1.0):
    d = str(tmp_path / f"{package.__name__.split('.')[0]}_{kind}_{scale}")
    if kind == "seg":
        save = package.seg_logit_spiller(d, scale=scale)
        for name, logits in _seg_logits(dataset).items():
            save(name, logits)
    else:
        save = package.lam_spiller(d)
        for name, (lam, keys) in _lams(dataset).items():
            save(name, lam, keys)
    return d


def _hists(dataset, logits_dir, kind):
    port = ppost.run_crf_post(dataset, logits_dir,
                              ppost.crf_from_cfg(CrfConfig()), NUM_CLASSES,
                              kind=kind, num_workers=2)
    jax = jpost.run_crf_post(dataset, logits_dir,
                             jpost.crf_from_cfg(JaxCrfConfig()), NUM_CLASSES,
                             kind=kind, num_workers=2)
    return port, jax


@pytest.mark.parametrize("kind,scale", [("seg", 1.0), ("seg", 0.2),
                                        ("lam", 1.0)])
def test_spills_cross_and_hists_equal_jax(dataset, tmp_path, kind, scale):
    """Each package's spill read by both post-passes: four equal hists;
    and the two packages' spill files hold the same arrays."""
    total = sum(int((dataset[i]["label"] < NUM_CLASSES).sum())
                for i in range(len(dataset)))
    dirs = [_spill(tmp_path, dataset, pkg, kind, scale)
            for pkg in (ppost, jpost)]
    hists = [h for d in dirs for h in _hists(dataset, d, kind)]
    assert hists[0].sum() == total and np.trace(hists[0]) > 0
    for h in hists[1:]:
        np.testing.assert_array_equal(h, hists[0])
    for name in dataset.names():
        a, b = (np.load(os.path.join(d, name + ".npy"),
                        allow_pickle=True).item() for d in dirs)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    if kind == "seg":
        h, w = dataset[0]["label"].shape
        spilled = np.load(os.path.join(dirs[0], dataset.names()[0] + ".npy"),
                          allow_pickle=True).item()["msc_seg"]
        assert spilled.shape == (1, NUM_CLASSES, max(1, int(scale * h)),
                                 max(1, int(scale * w)))


@pytest.mark.parametrize("kind", ["seg", "lam"])
def test_streaming_equals_post_pass(dataset, tmp_path, kind):
    d = _spill(tmp_path, dataset, ppost, kind)
    crf = ppost.crf_from_cfg(CrfConfig())
    preds, streamed = {}, {}
    hist = ppost.run_crf_post(dataset, d, crf, NUM_CLASSES, kind=kind,
                              num_workers=2,
                              save_pred=lambda n, p: preds.update({n: p}))
    post = ppost.StreamingCrfPost(
        dataset, d, crf, NUM_CLASSES, kind=kind, num_workers=2,
        save_pred=lambda n, p: streamed.update({n: p}))
    for name in dataset.names():
        post.submit(name)
    np.testing.assert_array_equal(post.finish(), hist)
    assert sorted(streamed) == sorted(preds) == sorted(dataset.names())
    for name, pred in preds.items():
        assert pred.dtype == np.int32
        np.testing.assert_array_equal(streamed[name], pred)


def test_stream_pool_keeps_order_and_bounds_jobs_in_flight():
    workers, n_jobs = 3, 20
    started = []
    lock = threading.Lock()
    rng = np.random.default_rng(0)
    delays = rng.random(n_jobs) * 0.01

    def fn(i):
        with lock:
            started.append(i)
        time.sleep(delays[i])
        return i

    for i, got in enumerate(ppost._stream_pool(n_jobs, fn, workers)):
        assert got == i
        with lock:
            assert len(started) <= i + 2 * workers
    assert sorted(started) == list(range(n_jobs))


def test_unknown_kind_raises(dataset, tmp_path):
    with pytest.raises(ValueError, match="kind"):
        ppost.run_crf_post(dataset, str(tmp_path), None, NUM_CLASSES,
                           kind="cams")
