"""The traffic generator: deterministic by seed, the same work for every
seed, and the mixes' stated shapes and class counts."""
import json
import os

import numpy as np
import pytest

from portbench.tests.common import BENCH
from portbench.harness import traffic as T


def _mix(name):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        return json.load(f)


def _small(mix, n=16):
    return dict(mix, pool_images=n)


@pytest.mark.parametrize("name", ["lam_sweep_voc", "lam_sweep_coco"])
def test_pool_is_deterministic_by_seed(name):
    mix = _small(_mix(name))
    a = T.make_pool(mix, 20, seed=2 ** 31 + 5)
    b = T.make_pool(mix, 20, seed=2 ** 31 + 5)
    c = T.make_pool(mix, 20, seed=2 ** 31 + 6)
    assert all(np.array_equal(x["image"], y["image"])
               and np.array_equal(x["label"], y["label"])
               for x, y in zip(a, b))
    assert any(not np.array_equal(x["image"], y["image"])
               for x, y in zip(a, c))


@pytest.mark.parametrize("name", ["lam_sweep_voc", "lam_sweep_coco"])
def test_every_seed_gets_the_same_work(name):
    mix = _small(_mix(name))
    nfg = 80 if mix["layout"] == "coco" else 20

    def work(seed):
        return sorted((s["image"].shape[:2], int(s["cls_label"].sum()))
                      for s in T.make_pool(mix, nfg, seed))

    assert work(1) == work(2 ** 31 + 11)


@pytest.mark.parametrize("name,mean,lo,hi", [
    ("lam_sweep_voc", 1.5, 1, 6), ("lam_sweep_coco", 3.5, 1, 20)])
def test_mix_shapes_and_class_counts(name, mean, lo, hi):
    mix = _mix(name)
    plan = T.pool_plan(mix, mix["pool_images"])
    ks = [k for _, _, k in plan]
    assert abs(np.mean(ks) - mean) < 0.15
    assert min(ks) == lo and max(ks) == hi
    land = sum(w > h for h, w, _ in plan) / len(plan)
    assert abs(land - mix["landscape_share"]) < 0.02
    lo_s, hi_s = mix["short_side"]
    for h, w, _ in plan:
        assert max(h, w) == mix["long_side"]
        assert lo_s <= min(h, w) <= hi_s


def test_scene_has_its_class_count():
    rng = np.random.default_rng(0)
    for k in (1, 6, 20):
        image, label = T.draw_scene(rng, 360, 640, k, 80)
        assert image.shape == (360, 640, 3) and label.shape == (360, 640)
        assert len(np.setdiff1d(np.unique(label), [0])) == k


def test_tree_reads_back_through_the_program(tmp_path):
    from excel_tpu_torch.data import datasets, jpeg

    for name, kind in (("lam_sweep_voc", datasets.VocDataset),
                       ("lam_sweep_coco", datasets.CocoDataset)):
        mix = _small(_mix(name), 4)
        nfg = 80 if mix["layout"] == "coco" else 20
        pool = T.make_pool(mix, nfg, 3)
        drawn = [s["image"].copy() for s in pool]
        root = tmp_path / name
        split_dir = T.write_tree(pool, mix, str(root))
        ds = datasets.EvalDataset(kind(str(root), split_dir, mix["split"],
                                       stage="val"))
        files = sorted(root.rglob("*.jpg"))
        assert len(files) == len(pool)
        for f in files:
            data = f.read_bytes()
            # baseline JPEG that the program's own decoder takes
            assert data[:2] == b"\xff\xd8" and jpeg.supported(data)
        for i, s in enumerate(pool):
            got = ds[i]
            # the pool holds the decode of its file: the blobs as drawn,
            # the noise background smoothed (its texture is what the
            # encoding loses most of)
            assert np.array_equal(got["image"], s["image"])
            err = np.abs(s["image"].astype(int) - drawn[i])
            fg = s["label"] > 0
            assert 0 < err[fg].mean() < 4 and err[~fg].mean() < 20
            assert np.array_equal(got["label"], s["label"])
            assert np.array_equal(got["cls_label"], s["cls_label"])
