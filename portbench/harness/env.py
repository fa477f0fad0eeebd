"""The run's surroundings: cache directories inside the checkout, the cards
a cell needs, and the check that JAX never loaded."""
from __future__ import annotations

import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "excel_tpu")


class NoCards(RuntimeError):
    pass


def set_cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own kernels build into excel_tpu_torch/_build/)."""
    cache = os.path.join(root, "portbench", "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def require_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoCards("no CUDA device is available")
    if torch.cuda.device_count() < n:
        raise NoCards(f"the cell needs {n} CUDA devices, "
                      f"{torch.cuda.device_count()} are present")


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: excel_tpu_torch is not excel_tpu."""
    tops = {n.split(".", 1)[0] for n in (sys.modules if names is None
                                         else names)}
    return sorted(t for t in tops if t in FORBIDDEN)
