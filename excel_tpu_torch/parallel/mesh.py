"""Batches and replicas of a data-parallel run (counterpart of
excel_tpu/parallel/mesh.py).

The JAX package lays one mesh over every device and lets XLA place the
arrays: the batch sharded over the data axis, the parameters replicated.
Here one process drives one device, and the process group takes the
mesh's place: each rank holds its own rows of the global batch and a full
copy of the head. What the mesh functions do by placement is done here by
hand: a rank takes its rows (`shard_local_batch`), and rank 0's head and
optimizer state are broadcast once after init or resume (`replicate`).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .distributed import _group_device, rank, world


def _tree_map(fn, tree):
    """fn over the leaves of nested dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def pad_to_multiple(batch: Any, multiple: int) -> tuple[Any, np.ndarray]:
    """Pad every leaf's batch dim up to a multiple with copies of its last
    row; returns (batch, valid), `valid` a host bool mask of the real rows
    (eval code weights padded rows to zero)."""
    b = _leaves(batch)[0].shape[0]
    pad = (-b) % multiple
    valid = np.concatenate([np.ones(b, bool), np.zeros(pad, bool)])
    if pad == 0:
        return batch, valid
    padded = _tree_map(
        lambda x: np.concatenate([x, np.repeat(x[-1:], pad, axis=0)]), batch)
    return padded, valid


def shard_local_batch(batch: Any, process_index: int | None = None,
                      process_count: int | None = None) -> Any:
    """This rank's rows [r*B, (r+1)*B) of every leaf of a global batch of
    B * world rows (the rows the data loader's shard of rank r yields);
    the batch itself at one process."""
    pi = rank() if process_index is None else process_index
    pc = world() if process_count is None else process_count
    if pc == 1:
        return batch

    def rows(x):
        b, rest = divmod(x.shape[0], pc)
        if rest:
            raise ValueError(f"a global batch of {x.shape[0]} rows does not "
                             f"split over {pc} ranks")
        return x[pi * b:(pi + 1) * b]

    return _tree_map(rows, batch)


def replicate(module: torch.nn.Module,
              optimizer: torch.optim.Optimizer | None = None) -> None:
    """Broadcast rank 0's parameters and buffers, and the optimizer's
    state, to every rank, in place (after init or resume, so that every
    rank steps the same head). Nothing without a group."""
    if not dist.is_initialized():
        return
    tensors = [*module.parameters(), *module.buffers()]
    if optimizer is not None:
        for group in optimizer.param_groups:
            for p in group["params"]:
                state = optimizer.state.get(p, {})
                tensors += [state[k] for k in sorted(state)
                            if isinstance(state[k], torch.Tensor)]
    dev = _group_device()
    with torch.no_grad():
        for t in tensors:
            buf = t.detach().to(dev, copy=True)
            dist.broadcast(buf, src=0)
            t.copy_(buf)
