"""Train-state checkpoints and the portable head file (counterpart of
excel_tpu/engine/checkpoint.py).

A checkpoint is one `torch.save` file, `<dir>/step_<n>.pt`, holding the
step, the head's state dict and the optimizer's state dict. The dropout
draws need no state of their own: each step's generator is seeded from
(cfg.train.seed, step) (engine/train.step_generator), so a resumed run
draws what an unbroken one would. The JAX package's orbax checkpoint
directories are not read; its head `.npz` files are, both ways: one array
per leaf, keyed by `jax.tree_util.keystr` of its path in the head tree.

Under a process group every rank holds the same head: rank 0 alone writes
the files, and every rank waits at a barrier until they are written, so
that every rank restores the same file on resume.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..config import HeadConfig
from ..models.head import LvcHead
from ..models.params import (_insert, _keystr_path, head_from_jax_params,
                             head_to_jax_tree, save_npz_tree)
from ..parallel.distributed import barrier, is_primary
from .train import TrainState


def save_checkpoint(ckpt_dir: str, state: TrainState) -> str:
    """Write `<ckpt_dir>/step_<n>.pt` (over an existing one, atomically;
    rank 0 writes, every rank waits); returns its path."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{state.step}.pt")
    if is_primary():
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = path + ".tmp"
        torch.save({"step": state.step, "head": state.head.state_dict(),
                    "optimizer": state.optimizer.state_dict()}, tmp)
        os.replace(tmp, path)
    barrier()
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(name[5:-3]) for name in os.listdir(ckpt_dir)
             if name.startswith("step_") and name.endswith(".pt")
             and name[5:-3].isdigit()]
    if not steps:
        return None
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{max(steps)}.pt")


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """Load a checkpoint into `template`'s head and optimizer (which fix
    the device and the optimizer kind); returns the template with its
    step set."""
    data = torch.load(path, map_location=next(
        template.head.parameters()).device, weights_only=True)
    template.head.load_state_dict(data["head"])
    template.optimizer.load_state_dict(data["optimizer"])
    template.step = int(data["step"])
    return template


def save_head_npz(path: str, head: LvcHead) -> None:
    """The head in the JAX package's `save_head_npz` layout (rank 0
    writes, every rank waits)."""
    if is_primary():
        save_npz_tree(path, head_to_jax_tree(head))
    barrier()


def load_head_npz(path: str, cfg: HeadConfig, num_classes: int,
                  device="cuda") -> LvcHead:
    """A head from a file in that layout (written by either package)."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            _insert(tree, _keystr_path(key), data[key])
    return head_from_jax_params(tree, cfg, num_classes, device)
