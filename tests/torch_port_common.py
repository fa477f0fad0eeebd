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
