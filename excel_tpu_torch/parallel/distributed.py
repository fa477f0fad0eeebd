"""Process group of a multi-device run (counterpart of
excel_tpu/parallel/distributed.py).

One process drives one device. A run over N devices is N processes, each
started by `torchrun`, which hands every process its RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT:

    torchrun --nproc_per_node 4 -m excel_tpu_torch.cli.train ...

`initialize` joins the group from that environment; the backend follows
the device (NCCL for cuda, gloo for cpu), and gloo may be asked for on the
card (ranks that share one card: NCCL refuses two ranks on one device).
Without the environment every function here is the single-process one:
no group, no collective, rank 0 of 1. With a group, world size 1
included, the collectives run.

The JAX package gets its global sums for free from a mesh that spans every
process. Here they are explicit: the training step's global reductions
(models/losses, models/head.feature_affinity, the gradient sum in
engine/train), and the eval sweeps' confusion hists (`global_sum_host`).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..utils import profiling

BACKENDS = ("nccl", "gloo")


def initialize(device: str | torch.device = "cuda",
               backend: str | None = None) -> bool:
    """Join the process group that torchrun's environment describes;
    returns whether a group is active.

    A no-op (False) without RANK / WORLD_SIZE in the environment, and at
    WORLD_SIZE 1 unless `backend` asks for a group. Idempotent. The
    backend is `backend`, else NCCL for a cuda `device` and gloo for the
    cpu. NCCL needs a device of its own per rank: ranks on one host that
    would share one (more local ranks than devices, or a device named with
    its index under several local ranks) raise here; pass backend="gloo"
    for them."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if int(os.environ["WORLD_SIZE"]) == 1 and backend is None:
        return False
    if dist.is_initialized():
        return True
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs a cuda device")
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        named = torch.device(device).index is not None
        if local > torch.cuda.device_count() or (named and local > 1):
            raise RuntimeError(
                f"nccl needs one device per rank: {local} local ranks, "
                f"{torch.cuda.device_count()} devices"
                + (f", every rank on {dev}" if named else "")
                + "; pass --dist-backend gloo for ranks that share a card")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://")
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Rank 0 alone writes files and tables."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing without a group)."""
    if dist.is_initialized():
        dist.barrier()


def _group_device() -> torch.device:
    """Where the group's collectives take their tensors: the rank's card
    under NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def group_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the group's ranks, detached (no gradient flows back
    through it); x itself without a group."""
    if not dist.is_initialized():
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out


def group_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the group's ranks of each rank's x, x a mean over a
    rank's rows of a batch that every rank holds as many rows of (so: the
    mean over the whole batch). Differentiable: the backward of the
    all_reduce hands every rank's share of the gradient to every rank. x
    itself without a group, and x / 1 = x at world size 1."""
    if not dist.is_initialized():
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x / dist.get_world_size())


def global_sum_host(x):
    """Sum a confusion hist across the group's ranks before it is scored:
    x itself without a group; else an int64 all_reduce on the group's
    device (integer-exact), returned as numpy. Every rank must call it."""
    if not dist.is_initialized():
        return x
    t = (x.detach() if isinstance(x, torch.Tensor)
         else torch.as_tensor(np.asarray(x)))
    if t.dtype.is_floating_point or t.dtype.is_complex:
        raise TypeError(f"global_sum_host sums integer hists, got {t.dtype}")
    t = t.to(_group_device(), torch.int64, copy=True)
    with profiling.span("allreduce"):
        dist.all_reduce(t)
    return t.cpu().numpy()


def shard_dataset(dataset, process_index: int | None = None,
                  process_count: int | None = None):
    """Round-robin view of an eval dataset for one process: samples
    index, index + count, ... The dataset itself at one process."""
    pi = rank() if process_index is None else process_index
    pc = world() if process_count is None else process_count
    if pc == 1:
        return dataset
    return _DatasetShard(dataset, pi, pc)


class _DatasetShard:
    def __init__(self, dataset, index: int, count: int):
        self._dataset = dataset
        self._idxs = list(range(index, len(dataset), count))

    def __len__(self):
        return len(self._idxs)

    def names(self) -> list[str]:
        base = self._dataset.names()
        return [base[i] for i in self._idxs]

    def __getitem__(self, i):
        return self._dataset[self._idxs[i]]
