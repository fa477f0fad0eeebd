"""The port's training data pipeline (excel_tpu_torch.data.datasets.
ClsCropDataset, data.loader.train_batches, cli.common.train_dataset)
against the JAX package's on the port's synthetic tree: the same crops
from the same seeded generators, and the same batch stream for 1 and 4
workers over batches that cross an epoch; engine/evaluate._batched."""
import dataclasses

import numpy as np
import pytest

from excel_tpu.cli import common as jcommon
from excel_tpu.config import tiny_config
from excel_tpu.data import ClsCropDataset as JaxClsCropDataset
from excel_tpu.data import VocDataset as JaxVocDataset
from excel_tpu.data import train_batches as jax_train_batches
from excel_tpu_torch.cli import common as pcommon
from excel_tpu_torch.config import tiny_config as port_tiny_config
from excel_tpu_torch.data import loader
from excel_tpu_torch.data.datasets import ClsCropDataset, VocDataset
from excel_tpu_torch.data.synthetic import make_voc_tree

KEYS = ("name", "image", "cls_label", "img_box", "label")
# 7 images, batches of 3: the batch size does not divide the dataset, and
# 6 batches cross two epoch boundaries
N_IMAGES, BATCH, N_BATCHES = 7, 3, 6
CROP = 96


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_data"))
    split_dir = make_voc_tree(root, num_images=N_IMAGES, seed=3, num_fg=5,
                              size_range=(40, 160))
    return root, split_dir


def _datasets(tree):
    root, split_dir = tree
    out = []
    for base_cls, crop_cls in ((VocDataset, ClsCropDataset),
                               (JaxVocDataset, JaxClsCropDataset)):
        base = base_cls(root, split_dir, "train_aug", "train")
        base.num_fg = 5
        out.append(crop_cls(base, crop_size=CROP))
    return out


def _assert_samples_equal(got: dict, ref: dict, keys=KEYS):
    for k in keys:
        if k == "name":
            assert list(got[k]) == list(ref[k])
            continue
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_cls_crop_samples_match_jax(tree):
    """Every sample under three seeds: the rescaled, flipped, padded crop,
    its label, img_box and class label."""
    port, ref = _datasets(tree)
    assert len(port) == len(ref) == N_IMAGES
    for seed in range(3):
        for i in range(N_IMAGES):
            _assert_samples_equal(
                port.__getitem__(i, rng=np.random.default_rng((seed, i))),
                ref.__getitem__(i, rng=np.random.default_rng((seed, i))))


def test_index_stream_matches_jax():
    from excel_tpu.data.loader import _index_stream as jax_index_stream

    for n, gb in ((7, 3), (4, 8), (5, 5)):
        a, b = loader._index_stream(n, gb, 11), jax_index_stream(n, gb, 11)
        assert [next(a) for _ in range(9)] == [next(b) for _ in range(9)]


@pytest.mark.parametrize("workers", [1, 4])
def test_train_batches_match_jax(tree, workers):
    port, ref = _datasets(tree)
    got = loader.train_batches(port, BATCH, seed=5, num_workers=workers)
    want = jax_train_batches(ref, BATCH, seed=5, num_workers=1)
    for _ in range(N_BATCHES):
        g, r = next(got), next(want)
        assert g["image"].shape == (BATCH, CROP, CROP, 3)
        _assert_samples_equal(g, r)
    got.close()
    want.close()


def test_ordered_pool_map_keeps_order_and_raises():
    import time

    def slow_square(x):
        time.sleep(0.002 * (5 - x % 5))
        if x == 7:
            raise KeyError(x)
        return x * x

    out = loader._ordered_pool_map(slow_square, range(7), 4, 2)
    assert list(out) == [x * x for x in range(7)]
    out = loader._ordered_pool_map(slow_square, range(10), 4, 2)
    assert [next(out) for _ in range(7)] == [x * x for x in range(7)]
    with pytest.raises(KeyError):
        next(out)


def test_train_dataset_of_the_synthetic_config(tree):
    """cli.common.train_dataset of both packages over the same tree and
    config: the same crops."""
    root, split_dir = tree
    jcfg, pcfg = tiny_config(), port_tiny_config()
    jcfg, pcfg = (dataclasses.replace(c, data=dataclasses.replace(
        c.data, root_dir=root, split_dir=split_dir, dataset="synthetic_voc"))
        for c in (jcfg, pcfg))
    port, ref = pcommon.train_dataset(pcfg), jcommon.train_dataset(jcfg)
    assert port.crop_size == ref.crop_size == pcfg.data.crop_size
    assert port.base.num_fg == ref.base.num_fg == pcfg.num_fg
    for i in range(3):
        _assert_samples_equal(
            port.__getitem__(i, rng=np.random.default_rng(i)),
            ref.__getitem__(i, rng=np.random.default_rng(i)))


def test_batched_matches_jax():
    """engine/evaluate._batched (the viz dump's first batch): the samples
    in order, the last batch filled with all-255 `_pad` copies."""
    from excel_tpu.engine.evaluate import _batched as jax_batched
    from excel_tpu_torch.engine.evaluate import _batched

    data = [dict(name=f"s{i}", label=np.full((2, 3), i, np.int32))
            for i in range(N_IMAGES)]
    got, ref = list(_batched(data, BATCH)), list(jax_batched(data, BATCH))
    assert len(got) == len(ref) == -(-N_IMAGES // BATCH)
    for g, r in zip(got, ref):
        assert [s["name"] for s in g] == [s["name"] for s in r]
        assert [s.get("_pad", False) for s in g] == [
            s.get("_pad", False) for s in r]
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a["label"], b["label"])
    assert got[-1][-1]["_pad"] and (got[-1][-1]["label"] == 255).all()
