"""On-device dense-CRF approximation: sparse convolutional mean-field
(counterpart of excel_tpu/ops/crf_tpu.py, same function names).

The bilateral + Gaussian pairwise Potts model of the reference's dense CRF,
evaluated over a sparse dilated neighbourhood (a convolutional CRF) instead
of the dense all-pairs kernel, so that MSC+flip inference and the LAM sweep
can post-process on the device. Pairwise weights:

  bi_w  * exp(-|dxy|^2 / 2 s_xy^2 - |dRGB|^2 / 2 s_rgb^2)   (bilateral)
  pos_w * exp(-|dxy|^2 / 2 s_pos^2)                          (Gaussian)

each offset weighted by the area of the annulus it stands for (ring
quadrature), normalised symmetrically (w_ij / sqrt(n_i n_j), n = filter(1))
before the Potts weight, with the mean-field update
Q <- softmax(log p + message). An optional coarse level evaluates the
bilateral kernel's long range on a grid of s x s cells.

The message of the fine level, sum_k w_k(i) Q(i + o_k), is the diffusion
step of PAR with 72 offsets up to 55 px: `ops/par_kernels.par_diffuse`, the
CUDA kernel on CUDA tensors (fp32, or bf16 with `msg_dtype`) and its plain
version on CPU tensors. Out-of-image neighbours carry zero weight, so the
kernel's clamped reads never count. The JAX function's `use_pallas` switch
has no counterpart: the port has one route per device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import CrfConfig
from ..utils import profiling
from .labels import scale_and_translate
from .par_kernels import offsets_tensor, par_diffuse

# 8 directions x dilations, spacing growing about geometrically; the support
# ends at +-55 px (about 0.8 sigma_xy of the reference's 67-px bilateral)
DEFAULT_DILATIONS = (1, 2, 3, 5, 8, 13, 21, 34, 55)

# Coarse long-range level: ring dilations in cells of stride 8, i.e. fine
# radii 72/96/128/168 px, which start past the fine support's outer edge
# (overlapping annuli would count kernel mass twice)
COARSE_STRIDE = 8
COARSE_DILATIONS = (9, 12, 16, 21)


def _offsets(dilations):
    offs = []
    for d in dilations:
        for dy in (-d, 0, d):
            for dx in (-d, 0, d):
                if dy == 0 and dx == 0:
                    continue
                offs.append((dy, dx))
    return offs


def _ring_edges(radii, lo0=None):
    """Annulus bounds per ring: midpoints to the adjacent rings; the
    innermost bound is radii[0]/2 unless `lo0` continues an inner set."""
    rs = sorted(radii)
    edges = [0.5 * (a + b) for a, b in zip(rs[:-1], rs[1:])]
    lo = [rs[0] / 2.0 if lo0 is None else lo0] + edges
    hi = edges + [rs[-1] + (rs[-1] - lo[-1])]
    return rs, lo, hi


def _quadrature_weights(dilations, scale=1.0, lo0=None):
    """Per-offset ring-quadrature weights, in `_offsets` order: the offset
    at dilation d stands in for the annulus of pixels between the midpoints
    to the adjacent rings, weight = annulus area / 8 samples (the dense
    kernel's mass grows with ring area; an unweighted sparse sum
    under-samples the wide bilateral at range).

    scale: ring radius per dilation unit (a coarse offset at stride s stands
    for an annulus measured in fine pixels). lo0: inner bound in fine pixels
    (the coarse annuli start where the fine support ends)."""
    ds = sorted(dilations)
    _, lo, hi = _ring_edges([scale * d for d in ds], lo0=lo0)
    area = {d: np.pi * (h * h - l * l) / 8.0 for d, l, h in zip(ds, lo, hi)}
    return [area[max(abs(dy), abs(dx))] for dy, dx in _offsets(dilations)]


def _support_radius(dilations):
    """Outer edge (in px) of the sparse support's last annulus."""
    return _ring_edges(sorted(dilations))[2][-1]


def _shift(x: torch.Tensor, dy: int, dx: int,
           fill: float = 0.0) -> torch.Tensor:
    """[..., H, W] shifted by (dy, dx): out[y, x] = x[y + dy, x + dx], `fill`
    where that lies outside the image."""
    h, w = x.shape[-2:]
    p = F.pad(x, (abs(dx), abs(dx), abs(dy), abs(dy)), value=fill)
    return p[..., abs(dy) + dy:abs(dy) + dy + h,
             abs(dx) + dx:abs(dx) + dx + w]


def crf_meanfield(images: torch.Tensor, probs: torch.Tensor, iters: int = 10,
                  pos_w: float = 3.0, pos_xy_std: float = 1.0,
                  bi_w: float = 4.0, bi_xy_std: float = 67.0,
                  bi_rgb_std: float = 3.0,
                  dilations: tuple[int, ...] = DEFAULT_DILATIONS,
                  valid_hw: torch.Tensor | None = None,
                  msg_dtype: torch.dtype | None = None,
                  quadrature: bool = True, coarse_stride: int = 0,
                  coarse_dilations: tuple[int, ...] = COARSE_DILATIONS
                  ) -> torch.Tensor:
    """images: [B, H, W, 3] RGB 0-255 (float or uint8), probs: [B, C, H, W]
    softmax probabilities, on one device. valid_hw: optional [B, 2]
    per-image valid extents on a padded canvas (pixels beyond them are
    treated as nonexistent, like out-of-image). msg_dtype: None (fp32) or
    torch.bfloat16: Q and the pairwise weights are stored in bf16 for the
    message pass; the update softmax(log p + message) stays fp32. Returns
    the refined Q [B, C, H, W] float32.

    coarse_stride > 0 adds a long-range bilateral level on a grid of s x s
    cells: each coarse offset stands in for an annulus of fine pixels
    (quadrature in fine-pixel units, continuing where the fine annuli end);
    cell colour and mass are valid-masked averages, the cell-pair weights
    are moment-matched to the cells' colour variance, and the symmetric
    normalisation is joint across both levels (n_i = fine + the upsampled
    coarse row-sum)."""
    if msg_dtype not in (None, torch.float32, torch.bfloat16):
        raise NotImplementedError(f"crf_meanfield: msg_dtype {msg_dtype}; "
                                  "float32 or bfloat16")
    if coarse_stride and not quadrature:
        raise ValueError("the coarse level needs annulus-area weights")
    b, c, h, w = probs.shape
    dev = probs.device
    img = images.float().permute(0, 3, 1, 2)                  # [B, 3, H, W]
    offs = _offsets(dilations)

    # per-offset kernels; out-of-image (or out-of-valid-extent) neighbours
    # get zero weight. The spatially constant pos kernel is never a stack:
    # its row-sum is a valid-mask contraction, its normalised form a
    # per-offset scalar times the valid mask.
    if valid_hw is None:
        vmap0 = torch.ones((1, h, w), dtype=torch.float32, device=dev)
    else:
        ys = torch.arange(h, device=dev)[None, :, None]
        xs = torch.arange(w, device=dev)[None, None, :]
        vmap0 = ((ys < valid_hw[:, 0:1, None])
                 & (xs < valid_hw[:, 1:2, None])).float()
    qws = _quadrature_weights(dilations) if quadrature else [1.0] * len(offs)
    # per-offset scalar factors: spatial gaussian x annulus quadrature
    bi_c = [float(np.exp(-(dy * dy + dx * dx) / (2.0 * bi_xy_std ** 2)) * q)
            for (dy, dx), q in zip(offs, qws)]
    pos_c = [float(np.exp(-(dy * dy + dx * dx) / (2.0 * pos_xy_std ** 2)) * q)
             for (dy, dx), q in zip(offs, qws)]
    valid_k = [_shift(vmap0, dy, dx) for dy, dx in offs]
    bi_k = []
    n_bi = torch.zeros_like(img[:, 0])                        # [B, H, W]
    n_pos = torch.zeros_like(vmap0)                           # [B|1, H, W]
    for (dy, dx), vk, bc, pc in zip(offs, valid_k, bi_c, pos_c):
        drgb2 = ((img - _shift(img, dy, dx)) ** 2).sum(dim=1)  # [B, H, W]
        k = bc * torch.exp(-drgb2 / (2.0 * bi_rgb_std ** 2)) * vk
        bi_k.append(k)
        n_bi = n_bi + k
        n_pos = n_pos + pc * vk

    coarse_msg = None
    if coarse_stride:
        s = coarse_stride
        h2, w2 = -(-h // s) * s, -(-w // s) * s
        offs_c = _offsets(coarse_dilations)
        quad_c = torch.tensor(
            _quadrature_weights(coarse_dilations, scale=float(s),
                                lo0=_support_radius(dilations)),
            dtype=torch.float32, device=dev)[None, :, None, None]

        def pool(x):
            x = F.pad(x, (0, w2 - w, 0, h2 - h))
            return x.reshape(*x.shape[:-2], h2 // s, s,
                             w2 // s, s).mean(dim=(-3, -1))

        cmask = pool(vmap0)                                   # [B|1, hc, wc]
        denom = torch.clamp(cmask[:, None], min=1e-6)
        cimg = pool(img * vmap0[:, None]) / denom             # [B, 3, hc, wc]
        # per-cell colour variance for moment-matched cell-pair weights: the
        # dense kernel couples pixel pairs, so a coarse sample is
        # E[exp(-|c_i - c_j|^2 / 2 s^2)] over the two cells' pixels, for
        # within-cell variance V: prod_ch sqrt(s^2 / (s^2 + V_i + V_j))
        # * exp(-|mu_i - mu_j|^2 / 2 (s^2 + V_i + V_j)), not exp of the mean
        # colours (which overestimates long-range affinity in textured cells)
        cvar = torch.clamp(
            pool((img * vmap0[:, None]) ** 2) / denom - cimg ** 2, min=0.0)
        sig2 = bi_rgb_std ** 2
        wc_k = []
        for dy, dx in offs_c:
            mu_d2 = (cimg - _shift(cimg, dy, dx)) ** 2        # [B, 3, hc, wc]
            s2 = sig2 + cvar + _shift(cvar, dy, dx)
            rgb = (torch.exp(-(mu_d2 / (2.0 * s2)).sum(dim=1))
                   * torch.sqrt(torch.prod(sig2 / s2, dim=1)))
            dxy2 = float(s * s * (dy * dy + dx * dx))
            wc_k.append(float(np.exp(-dxy2 / (2.0 * bi_xy_std ** 2))) * rgb)
        wc = torch.stack(wc_k, dim=1) * quad_c                # [B, Kc, hc, wc]
        nb_cmask = torch.stack([_shift(cmask, dy, dx) for dy, dx in offs_c],
                               dim=1)
        n_c = (wc * nb_cmask).sum(dim=1)                      # [B, hc, wc]
        n_up = n_c.repeat_interleave(s, dim=-2).repeat_interleave(
            s, dim=-1)[..., :h, :w]
        n_bi = n_bi + n_up * vmap0

    # symmetric normalisation per kernel, k_ij / sqrt(n_i n_j) with
    # n = filter(1), BEFORE the Potts weight (after would cancel its scale),
    # in one pass over the K-stack: aff_k = bi_w bi_k inv_bi_i inv_bi_j
    # + pos_w c_k v_k inv_pos_i inv_pos_j
    inv_bi = torch.rsqrt(torch.clamp(n_bi, min=1e-12))
    inv_pos = torch.rsqrt(torch.clamp(n_pos, min=1e-12))
    aff = torch.stack(
        [bi_w * k * inv_bi * _shift(inv_bi, dy, dx)
         + (pos_w * pc) * vk * inv_pos * _shift(inv_pos, dy, dx)
         for (dy, dx), k, vk, pc in zip(offs, bi_k, valid_k, pos_c)],
        dim=1)
    del bi_k, valid_k

    if coarse_stride:
        invv = inv_bi * vmap0             # inv at fine res, 0 out-of-valid
        up_scale = torch.tensor([[h2 / (h2 // s), w2 / (w2 // s)]],
                                dtype=torch.float32, device=dev).expand(b, 2)

        def coarse_msg(qq):
            # msg_i = inv_i sum_k wc_k(cell) cellmean(inv Q)(cell + o_k):
            # each coarse sample stands in for annulus-area fine pixels of
            # the same jointly normalised bilateral kernel
            p = pool(qq * invv[:, None])                      # [B, C, hc, wc]
            acc = torch.zeros_like(p)
            for k, (dy, dx) in enumerate(offs_c):
                acc = acc + wc[:, k:k + 1] * _shift(p, dy, dx)
            m = scale_and_translate(acc, (h2, w2), up_scale,
                                    torch.zeros_like(up_scale))
            return bi_w * m[..., :h, :w] * inv_bi[:, None]

    unary = torch.log(torch.clamp(probs.float(), min=1e-20))
    q = torch.softmax(unary, dim=1)

    store = msg_dtype or torch.float32
    aff_m = aff.to(store).contiguous()
    offsets = offsets_tensor(offs, dev)
    with profiling.span("crf"):
        for _ in range(iters):
            m = par_diffuse(q.to(store).contiguous(), aff_m, offsets).float()
            if coarse_msg is not None:
                m = m + coarse_msg(q)
            q = torch.softmax(unary + m, dim=1)
    return q


def crf_meanfield_cfg(images, probs, cfg: CrfConfig, **kw):
    kw.setdefault("msg_dtype", torch.bfloat16 if cfg.msg_bf16 else None)
    kw.setdefault("coarse_stride", COARSE_STRIDE if cfg.long_range else 0)
    return crf_meanfield(images, probs, iters=cfg.iters, pos_w=cfg.pos_w,
                         pos_xy_std=cfg.pos_xy_std, bi_w=cfg.bi_w,
                         bi_xy_std=cfg.bi_xy_std, bi_rgb_std=cfg.bi_rgb_std,
                         **kw)
