"""TSE — text-semantic enrichment via the attribute cluster bank
(counterpart of excel_tpu/ops/tse.py).

Each foreground class embedding attends over the K-cluster bank: the
int((1 - top_keep) * K) LOWEST logits of each class are dropped, the rest
softmaxed, the aggregated attributes added to the class embedding, the
background classes re-appended, and every row L2-normalised.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def attr_aggregate(text_features: torch.Tensor, cluster_bank: torch.Tensor,
                   num_fg: int, top_keep: float = 0.9) -> torch.Tensor:
    """Enrich fg class embeddings with soft-aggregated cluster attributes.

    text_features: [T, C] prompt-ensemble class embeddings (fg then bg rows)
    cluster_bank:  [C, K] cluster centroid embeddings (feature-major, the
                   saved bank layout)
    Returns [T, C] float32 rows of unit norm, whatever the input types. The
    dropped columns are the last n_drop of a stable argsort of -logits, so
    tied logits drop the same columns as `jnp.argsort`."""
    fg = text_features[:num_fg].float()
    bg = text_features[num_fg:].float()
    bank = cluster_bank.float()
    k = bank.shape[1]

    logits = fg @ bank                                    # [num_fg, K]
    n_drop = int((1.0 - top_keep) * k)
    if n_drop > 0:
        order = torch.argsort(-logits, dim=-1, stable=True)   # descending
        logits = logits.scatter(1, order[:, k - n_drop:], -torch.inf)
    corr = torch.softmax(logits, dim=-1)
    fg_agg = corr @ bank.T + fg                           # [num_fg, C]

    out = torch.cat([fg_agg, bg], dim=0)
    return out / torch.linalg.vector_norm(out, dim=1, keepdim=True)


def load_attr_bank(path: str, device="cuda") -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """A converted bank file -> (bank [embed, K], flags [num_fg, K]) on
    `device`."""
    device = resolve_device(device)
    with np.load(path) as data:
        return (torch.from_numpy(data["cluster_bank"]).to(device),
                torch.from_numpy(data["class_flags"]).to(device))
