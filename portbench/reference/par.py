"""PAR, the pixel-adaptive refinement, for one image at its own size.

Restates excel_tpu_torch/ops/par.py (`_offsets`, `_pos_weight`,
`_affinity`, the diffusion of `par_refine`) in plain operations: the
appearance affinity over the 48 dilated neighbours (unbiased standard
deviation over the shifts, a softmax over the shifts of the channel-mean
squared scaled differences, plus w2 times the position softmax), then
`iters` steps new = sum_k aff_k * shift_k(masks), every read at the image's
edge replicated. The program computes the same on a padded canvas whose
pad it re-replicates from each image's valid extent, which is this
function inside that extent.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .precision import FP32


def offsets(dilations):
    return [(dy, dx) for d in dilations for dy in (-d, 0, d)
            for dx in (-d, 0, d) if (dy, dx) != (0, 0)]


def pos_weight(dilations, w1=0.3):
    pos = np.asarray([(np.sqrt(2.0) if i in (0, 2, 5, 7) else 1.0) * d
                      for d in dilations for i in range(8)], np.float64)
    aff = -((pos / (pos.std(ddof=1) + 1e-8) / w1) ** 2)
    e = np.exp(aff - aff.max())
    return (e / e.sum()).astype(np.float32)


def _shifts(x, offs, pad):
    h, w = x.shape[-2:]
    xp = F.pad(x[None], (pad, pad, pad, pad), mode="replicate")[0]
    return [xp[:, pad + dy:pad + dy + h, pad + dx:pad + dx + w]
            for dy, dx in offs]


def affinity(img, dilations, w1=0.3, w2=0.01):
    """img [3, h, w] -> [K, h, w]."""
    offs = offsets(dilations)
    pad = max(max(abs(a), abs(b)) for a, b in offs)
    nb = torch.stack(_shifts(img.float(), offs, pad))          # [K, 3, h, w]
    std = nb.std(dim=0, unbiased=True)
    logits = -(((nb - img[None]).abs() / ((std + 1e-8) * w1)[None]) ** 2
               ).mean(dim=1)
    aff = torch.softmax(logits, dim=0)
    pos = torch.from_numpy(pos_weight(dilations, w1)).to(img.device)
    return aff + w2 * pos[:, None, None]


def refine(img, masks, dilations, iters=20, w1=0.3, w2=0.01, prec=FP32):
    """Diffuse masks [C, h, w] along the affinity of img [3, h, w]."""
    offs = offsets(dilations)
    pad = max(max(abs(a), abs(b)) for a, b in offs)
    aff = prec.store(affinity(img, dilations, w1, w2))
    m = prec.store(masks.float())
    for _ in range(iters):
        new = torch.zeros_like(m)
        for k, nb in enumerate(_shifts(m, offs, pad)):
            new += aff[k][None] * nb
        m = prec.store(new)
    return m
