"""PAR — pixel-adaptive refinement (counterpart of excel_tpu/ops/par.py).

fp32 (the default): the affinity is computed once with a streaming two-pass
over the 48 neighbour shifts (mean/variance accumulators, then per-shift
logits and a softmax over shifts, plus the constant position term); the
diffusion then runs `num_iter` steps of `ops/par_kernels.par_diffuse`, the
CUDA kernel on CUDA tensors. With per-image valid extents on a padded
canvas, the pad region is re-replicated from the valid border before the
affinity pass and after every step, which makes the valid region exactly
the per-size result. Without extents (training's crop-resolution
pseudo-labels) the steps chain with nothing between them: this is the
function of the JAX package's full-extent padded route (Pallas
`_diffuse_hcw_kernel`), whose edge-padded canvas holds what the kernel's
clamped reads see.

bf16 storage (the fast preset): the route of the JAX package's Pallas
kernels. The images go through `pad_replicate_valid` and `par_affinity`
(fp32 moments and softmax, bf16 affinities); the masks go to bf16,
through `pad_replicate_valid`, and `par_diffuse_valid_resident` runs every
step in one launch (bf16 products, fp32 sums in chunks of 8 offsets, the
valid clamp fused in). Without extents the clamp is at the full extent,
which is the function of the JAX package's `_diffuse_padded_kernel` (and
the route it takes itself for full-extent bf16). The JAX package splits
the channels into groups that fit the TPU's VMEM; channels diffuse
independently, so the port diffuses them all at once.

bf16 with a pad that is not a multiple of 8 (the tiny test configuration's
dilations (1, 2)): the JAX package's padded kernels need 8-aligned pads,
and its Pallas route there (`use_pallas=True` or "interpret") is the
per-step one: the fp32 affinity and the valid-clamped masks rounded to
bf16, then `par_diffuse` in bf16 (sums rounded to bf16 between chunks of 8
offsets) and `_replicate_valid` each step. The port mirrors that route
(`bf16_route`). Every 8-aligned pad takes the padded route, as in the JAX
package: the affinity kernel takes any pad and up to 128 offsets (its
direct kernel where the slab does not fit), the resident diffusion up to
128 offsets and a pad of 64, and raises on the card beyond that.
(Where the JAX package runs without Pallas, on a CPU by default, it takes
an XLA loop instead, which rounds its sum to bf16 after every offset; the
port has no counterpart of that loop.)
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import profiling
from .par_kernels import (offsets_tensor, pad_replicate_valid, par_affinity,
                          par_diffuse, par_diffuse_valid_resident)


def _offsets(dilations) -> list[tuple[int, int]]:
    offs = []
    for d in dilations:
        for dy in (-d, 0, d):
            for dx in (-d, 0, d):
                if dy == 0 and dx == 0:
                    continue
                offs.append((dy, dx))
    return offs


def _pos_weight(dilations) -> np.ndarray:
    """softmax over the constant position affinity: per dilation the 8
    neighbours in row-major order, diagonals weighted sqrt(2)*d, axial d."""
    pos = []
    for d in dilations:
        for i in range(8):
            diag = i in (0, 2, 5, 7)
            pos.append((np.sqrt(2.0) if diag else 1.0) * d)
    pos = np.asarray(pos, dtype=np.float64)
    std = pos.std(ddof=1)
    w1 = 0.3
    aff = -((pos / (std + 1e-8) / w1) ** 2)
    e = np.exp(aff - aff.max())
    return (e / e.sum()).astype(np.float32)


def _replicate_valid(x: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
    """Overwrite the region outside each image's valid [h, w] extent with the
    clamped border value. x: [B, C, H, W], valid_hw: [B, 2] int."""
    b, c, h, w = x.shape
    vh = valid_hw[:, 0:1].long()
    vw = valid_hw[:, 1:2].long()
    rows = torch.minimum(torch.arange(h, device=x.device)[None], vh - 1)
    x = torch.gather(x, 2, rows[:, None, :, None].expand(b, c, h, w))
    cols = torch.minimum(torch.arange(w, device=x.device)[None], vw - 1)
    return torch.gather(x, 3, cols[:, None, None, :].expand(b, c, h, w))


def _shift(padded: torch.Tensor, dy: int, dx: int, h: int, w: int,
           pad: int) -> torch.Tensor:
    return padded[..., pad + dy:pad + dy + h, pad + dx:pad + dx + w]


def _affinity(imgs: torch.Tensor, dilations, w1: float,
              w2: float) -> torch.Tensor:
    """PAR appearance affinity [B, K, H, W] of (already valid-replicated)
    images [B, 3, H, W]: unbiased std over the K shifts, per-shift logits
    -mean_c((|n - x| / ((std + 1e-8) w1))^2), softmax over shifts, plus
    w2 * the position softmax."""
    h, w = imgs.shape[-2:]
    offs = _offsets(dilations)
    k = len(offs)
    pad = max(max(abs(dy), abs(dx)) for dy, dx in offs)
    ip = F.pad(imgs, (pad, pad, pad, pad), mode="replicate")
    s1 = torch.zeros_like(imgs)
    s2 = torch.zeros_like(imgs)
    for dy, dx in offs:
        n = _shift(ip, dy, dx, h, w, pad)
        s1 = s1 + n
        s2 = s2 + n * n
    mean = s1 / k
    var = torch.clamp(s2 / k - mean * mean, min=0.0) * (k / (k - 1.0))
    inv = 1.0 / ((torch.sqrt(var) + 1e-8) * w1)
    logits = torch.stack(
        [(-torch.square(torch.abs(_shift(ip, dy, dx, h, w, pad) - imgs) * inv)
          ).mean(dim=1) for dy, dx in offs], dim=1)
    aff = torch.softmax(logits, dim=1)
    pos = torch.from_numpy(_pos_weight(dilations)).to(imgs.device)
    return aff + w2 * pos[None, :, None, None]


def fill_counts(cls_label, valid_hw, canvas: tuple[int, int],
                channels: int, blank=None) -> tuple[int, int]:
    """(refined, useful) channel-pixels of one `par_refine` over a batch,
    from host values: refined, the batch's images x `channels` (background
    + the class slots, or + every class on the full stack) x the canvas's
    pixels; useful, over the images that are not `blank` (remainder
    padding), (1 + their present classes) x their valid pixels.
    cls_label [B, num_fg]; valid_hw [B, 2]; blank [B] bool or None."""
    cls = np.asarray(cls_label)
    present = (cls > 0).sum(axis=1)
    area = np.prod(np.asarray(valid_hw, np.int64), axis=1)
    useful = (1 + present) * area
    if blank is not None:
        useful = useful[~np.asarray(blank, bool)]
    return (len(cls) * channels * canvas[0] * canvas[1], int(useful.sum()))


def bf16_route(dilations) -> str:
    """The route of bf16 `par_refine` at these dilations, from the shapes
    alone, as the JAX package picks its Pallas route: "padded" (pad-clamp,
    affinity and resident diffusion kernels) for a pad that is a multiple
    of 8, else "per_step" (the fp32 affinity, then row 5's bf16 step and
    `_replicate_valid` per step)."""
    pad = max(max(abs(dy), abs(dx)) for dy, dx in _offsets(dilations))
    return "padded" if pad % 8 == 0 else "per_step"


def par_refine(imgs: torch.Tensor, masks: torch.Tensor,
               dilations=(1, 2, 4, 8, 12, 24), num_iter: int = 20,
               w1: float = 0.3, w2: float = 0.01,
               valid_hw: torch.Tensor | None = None,
               dtype: torch.dtype | None = None) -> torch.Tensor:
    """Diffuse `masks` [B, C, H, W] along the affinities of `imgs`
    [B, 3, H, W] (same spatial size). valid_hw: optional [B, 2] int32
    per-image valid extents on a padded canvas. dtype: None or float32, or
    bfloat16 for the fast preset's bf16 storage. Returns [B, C, H, W]
    float32."""
    store = dtype or torch.float32
    if store not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"PAR storage {dtype}: float32 or bfloat16")
    with profiling.span("par"):
        if store == torch.bfloat16 and bf16_route(dilations) == "padded":
            return _par_refine_bf16(imgs, masks, dilations, num_iter, w1, w2,
                                    valid_hw)
        # the per-step route: fp32, or bf16 storage at a pad that is not a
        # multiple of 8
        imgs = imgs.float()
        masks = masks.float()
        if valid_hw is not None:
            masks = _replicate_valid(masks, valid_hw)
            imgs = _replicate_valid(imgs, valid_hw)
        aff = _affinity(imgs, dilations, w1, w2).to(store).contiguous()
        offsets = offsets_tensor(_offsets(dilations), masks.device)
        m = masks.to(store).contiguous()
        for _ in range(num_iter):
            m = par_diffuse(m, aff, offsets)
            if valid_hw is not None:
                m = _replicate_valid(m, valid_hw)
        return m.float()


def _par_refine_bf16(imgs, masks, dilations, num_iter, w1, w2, valid_hw):
    offs = _offsets(dilations)
    pad = max(max(abs(dy), abs(dx)) for dy, dx in offs)
    b, _, h, w = imgs.shape
    if valid_hw is None:
        # full extents: the valid clamp is plain edge padding
        valid_hw = torch.tensor([h, w], dtype=torch.int32).expand(b, 2)
    valid_hw = valid_hw.to(device=masks.device, dtype=torch.int32).contiguous()
    pos_w = [float(x) for x in _pos_weight(dilations)]
    ip = pad_replicate_valid(imgs.float().contiguous(), valid_hw, pad)
    aff = par_affinity(ip, offs, pos_w, h, w, w1=w1, w2=w2,
                       out_dtype=torch.bfloat16)
    mp = pad_replicate_valid(masks.to(torch.bfloat16).contiguous(), valid_hw,
                             pad)
    if num_iter >= 1:
        mp = par_diffuse_valid_resident(mp, aff, valid_hw, offs, h, w,
                                        num_iter)
    return mp[:, :, pad:pad + h, pad:pad + w].float()

