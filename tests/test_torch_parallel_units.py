"""The port's parallel/ package and device rule on the CPU: the dataset
shard and pad_to_multiple against the JAX package's, a rank's rows of the
global batch (shard_local_batch, and the loader's shard against the
one-process stream), the functions without a group (no collective, the
single-process results), `replicate` across 2 gloo ranks, and the device
of a rank: "cuda" is the rank's own card, a named card that one, a card
that does not exist raises, and two NCCL ranks on one card raise before
NCCL is reached."""
import itertools
import os

import numpy as np
import pytest
import torch

from excel_tpu.data import train_batches as jax_train_batches
from excel_tpu.parallel import distributed as jdist
from excel_tpu.parallel import mesh as jmesh
from excel_tpu_torch import device as pdevice
from excel_tpu_torch.data import loader
from excel_tpu_torch.parallel import distributed as pdist
from excel_tpu_torch.parallel import mesh as pmesh
from torch_parallel_common import run_ranks

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


class Names:
    """An eval dataset of n named samples."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def names(self):
        return [f"s{i}" for i in range(self.n)]

    def __getitem__(self, i):
        return {"name": f"s{i}"}


class Crops:
    """A train dataset whose samples are drawn from the generator the
    loader hands them, so a row shows both its index and its seed."""

    def __len__(self):
        return 7

    def __getitem__(self, i, rng=None):
        return {"name": f"s{i}", "image": rng.integers(0, 256, (4, 4, 3)),
                "cls_label": np.eye(7, dtype=np.float32)[i],
                "img_box": np.asarray([0, 4, 0, 4]),
                "label": rng.integers(0, 5, (4, 4))}


@pytest.mark.parametrize("index,count", [(0, 1), (0, 2), (1, 2), (2, 3),
                                         (4, 5)])
def test_shard_dataset_matches_jax(index, count):
    ds = Names(11)
    got = pdist.shard_dataset(ds, index, count)
    want = jdist.shard_dataset(ds, index, count)
    assert len(got) == len(want)
    assert got.names() == want.names()
    assert [got[i] for i in range(len(got))] == [
        want[i] for i in range(len(want))]


@pytest.mark.parametrize("multiple", [1, 3, 4])
def test_pad_to_multiple_matches_jax(multiple):
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (5, 3, 3, 3), dtype=np.uint8),
             "meta": (rng.normal(size=(5, 2)).astype(np.float32),
                      np.arange(5))}
    got, got_valid = pmesh.pad_to_multiple(batch, multiple)
    want, want_valid = jmesh.pad_to_multiple(batch, multiple)
    np.testing.assert_array_equal(got_valid, want_valid)
    np.testing.assert_array_equal(got["images"], want["images"])
    for g, w in zip(got["meta"], want["meta"]):
        np.testing.assert_array_equal(g, w)


def test_shard_local_batch_takes_the_ranks_rows():
    x = np.arange(12).reshape(6, 2)
    for r in range(3):
        np.testing.assert_array_equal(
            pmesh.shard_local_batch((x,), r, 3)[0], x[2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="does not split"):
        pmesh.shard_local_batch(x, 0, 4)


@pytest.mark.parametrize("rank", [0, 1])
def test_loader_shard_is_the_rows_of_one_process(rank):
    """Rank r of 2 at B=2 streams rows [2r, 2r+2) of one process's stream
    at B=4, crops included, as the JAX package's shard does."""
    one = loader.train_batches(Crops(), 4, seed=5)
    mine = loader.train_batches(Crops(), 2, seed=5, process_index=rank,
                                process_count=2)
    ref = jax_train_batches(Crops(), 2, seed=5, process_index=rank,
                            process_count=2)
    for whole, got, want in itertools.islice(zip(one, mine, ref), 4):
        for k in loader.BATCH_KEYS:
            rows = whole[k][2 * rank:2 * rank + 2]
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(rows))
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))


def test_no_group_without_torchrun(monkeypatch):
    """Without torchrun's environment, or at world size 1 without a
    backend, nothing joins a group and every function is the
    single-process one (the same objects back)."""
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert pdist.initialize("cpu") is False
    assert pdist.initialize("cpu", "gloo") is False
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert pdist.initialize("cpu") is False
    assert not torch.distributed.is_initialized()
    assert (pdist.rank(), pdist.world(), pdist.is_primary()) == (0, 1, True)
    hist = torch.arange(9).reshape(3, 3)
    assert pdist.global_sum_host(hist) is hist
    x = torch.tensor(2.5)
    assert pdist.group_sum(x) is x and pdist.group_mean(x) is x
    pdist.barrier()
    ds = Names(3)
    assert pdist.shard_dataset(ds) is ds
    batch = (np.arange(4),)
    assert pmesh.shard_local_batch(batch)[0] is batch[0]
    head = torch.nn.Linear(2, 2)
    before = [p.detach().clone() for p in head.parameters()]
    pmesh.replicate(head)
    for a, b in zip(before, head.parameters()):
        assert torch.equal(a, b)


@pytest.fixture
def one_card(monkeypatch):
    """A host that reports one CUDA device (nothing is launched)."""
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    return monkeypatch


def test_device_of_a_rank(one_card):
    assert pdevice.resolve_device("cuda") == torch.device("cuda")
    assert pdevice.resolve_device("cpu") == torch.device("cpu")
    one_card.setenv("LOCAL_RANK", "0")
    assert pdevice.resolve_device("cuda") == torch.device("cuda", 0)
    one_card.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="cuda:1 does not exist"):
        pdevice.resolve_device("cuda")
    assert pdevice.resolve_device("cuda:0") == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="cuda:2 does not exist"):
        pdevice.resolve_device("cuda:2")


def test_two_nccl_ranks_on_one_card_raise(one_card):
    """Two local ranks and one card: NCCL is refused with the way out
    (gloo) before init_process_group is called."""
    def refuse(*a, **k):
        raise AssertionError("init_process_group reached")

    one_card.setattr(torch.distributed, "init_process_group", refuse)
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "0"),
                 ("LOCAL_WORLD_SIZE", "2")):
        one_card.setenv(k, v)
    with pytest.raises(RuntimeError, match="one device per rank.*gloo"):
        pdist.initialize("cuda")
    with pytest.raises(RuntimeError, match="every rank on cuda:0"):
        pdist.initialize("cuda:0")
    with pytest.raises(RuntimeError, match="one device per rank"):
        pdist.initialize("cuda:0", "nccl")
    with pytest.raises(ValueError, match="needs a cuda device"):
        pdist.initialize("cpu", "nccl")
    with pytest.raises(ValueError, match="backend 'mpi'"):
        pdist.initialize("cpu", "mpi")
    one_card.setenv("RANK", "1")
    one_card.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="cuda:1 does not exist.*gloo"):
        pdist.initialize("cuda")


def test_replicate_broadcasts_rank_zero(tmp_path):
    """Two ranks with different heads and optimizer states: after
    `replicate` both hold rank 0's, and rank 0's are unchanged."""
    run_ranks(2, "replicate", str(tmp_path))
    got = [np.load(str(tmp_path / f"rank{r}_replicate.npz"))
           for r in range(2)]
    for k in got[0].files:
        if k.startswith("before"):
            continue
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
        np.testing.assert_array_equal(got[0][k], got[0]["before_" + k],
                                      err_msg=k)
    assert not np.array_equal(got[1]["params"], got[1]["before_params"])
