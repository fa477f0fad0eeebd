"""Helpers shared by the tests that hold the PyTorch port (excel_tpu_torch)
against the JAX package: inputs are made with numpy from a seed and handed
to both as arrays."""
from __future__ import annotations

import jax
import numpy as np
import torch

# the suite runs under several worker processes: one thread each
torch.set_num_threads(1)


def jax_clip_tree(cfg_clip, seed: int = 0) -> dict:
    """JAX-package CLIP parameters as a numpy tree."""
    from excel_tpu.models.params import init_clip_params

    return jax.device_get(init_clip_params(jax.random.PRNGKey(seed),
                                           cfg_clip))


def port_params(tree: dict, cfg_clip) -> dict:
    from excel_tpu_torch.models.params import from_jax_params

    return from_jax_params(tree, cfg_clip, device="cpu")


def t(a) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor (same dtype)."""
    return torch.from_numpy(np.array(a))


def n(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def jax_head_tree(cfg, seed: int = 0) -> dict:
    """JAX-package LVC head parameters (cfg: an ExcelConfig) as a numpy
    tree."""
    from excel_tpu.models.head import init_head_params

    return jax.device_get(init_head_params(jax.random.PRNGKey(seed),
                                           cfg.head, cfg.num_classes))


def jax_interpret_cfg(cfg):
    """A JAX-package config whose encoder runs its Pallas attention kernels
    in interpret mode (their sums in the kernels' order, as the port's
    plain versions take them)."""
    import dataclasses

    return dataclasses.replace(cfg, clip=dataclasses.replace(
        cfg.clip, fused_attention="interpret"))


def port_head(tree: dict, cfg):
    from excel_tpu_torch.models.params import head_from_jax_params

    return head_from_jax_params(tree, cfg.head, cfg.num_classes,
                                device="cpu")


def train_batch(cfg, b: int, seed: int = 0, max_classes: int = 2):
    """uint8 crops [b, S, S, 3], one-hot labels with 1 to `max_classes`
    classes each (image i has 1 + i % max_classes) and a text bank
    (num_fg + 3 rows), from a numpy seed."""
    rng = np.random.default_rng(seed)
    s = cfg.clip.image_size
    images = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    cls = np.zeros((b, cfg.num_fg), np.float32)
    for i in range(b):
        cls[i, rng.choice(cfg.num_fg, size=1 + i % max_classes,
                          replace=False)] = 1.0
    text = rng.normal(size=(cfg.num_fg + 3, cfg.clip.embed_dim)).astype(
        np.float32)
    return images, cls, text
