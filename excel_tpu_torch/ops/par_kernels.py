"""One PAR diffusion step: the CUDA kernel and its plain version.

Counterpart of excel_tpu/ops/par_pallas.py `par_diffuse`: csrc/par_diffuse.cu
replaces the Pallas `_diffuse_kernel`. The step is

    new[b, c, y, x] = sum_k aff[b, k, y, x] * m[b, c, y + dy_k, x + dx_k]

with reads clamped to the canvas (edge replication). It is bound by device
memory (the affinity stack is read once per step); the source says how.

On a CPU tensor `par_diffuse` computes the plain version; on a CUDA tensor
it launches the kernel or raises. `par_diffuse.launches` counts launches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import build


def offsets_tensor(offsets, device) -> torch.Tensor:
    """[(dy, dx), ...] -> the [K, 2] int32 tensor `par_diffuse` takes."""
    return torch.tensor(offsets, dtype=torch.int32, device=device).reshape(
        -1, 2)


def par_diffuse_reference(masks: torch.Tensor, aff: torch.Tensor,
                          offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of `par_diffuse`: edge-pad, then one shifted product per
    offset, summed in offset order."""
    _, _, h, w = masks.shape
    offs = offsets.tolist()
    pad = max(max(abs(dy), abs(dx)) for dy, dx in offs)
    mp = F.pad(masks, (pad, pad, pad, pad), mode="replicate")
    acc = torch.zeros_like(masks)
    for i, (dy, dx) in enumerate(offs):
        shifted = mp[:, :, pad + dy:pad + dy + h, pad + dx:pad + dx + w]
        acc = acc + shifted * aff[:, i:i + 1]
    return acc


def par_diffuse(masks: torch.Tensor, aff: torch.Tensor,
                offsets: torch.Tensor) -> torch.Tensor:
    """masks: [B, C, H, W] float32, aff: [B, K, H, W] float32, offsets:
    [K, 2] int32 (dy, dx) on the same device, all contiguous.
    Returns the diffused [B, C, H, W] masks."""
    if masks.dim() != 4 or aff.dim() != 4:
        raise ValueError("masks and aff must be [B, C, H, W] / [B, K, H, W]")
    b, c, h, w = masks.shape
    k = aff.shape[1]
    if aff.shape != (b, k, h, w) or offsets.shape != (k, 2):
        raise ValueError(f"shape mismatch: masks {tuple(masks.shape)}, aff "
                         f"{tuple(aff.shape)}, offsets {tuple(offsets.shape)}")
    if masks.dtype != torch.float32 or aff.dtype != torch.float32:
        raise NotImplementedError(
            "bf16 PAR diffusion belongs to the fast-preset slice; this "
            "slice's kernel is fp32")
    if offsets.dtype != torch.int32:
        raise ValueError("offsets must be int32")
    for t in (aff, offsets):
        if t.device != masks.device:
            raise ValueError("masks, aff and offsets must be on one device")
    if not (masks.is_contiguous() and aff.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError("masks, aff and offsets must be contiguous")
    if masks.device.type == "cpu":
        return par_diffuse_reference(masks, aff, offsets)
    if masks.device.type != "cuda":
        raise ValueError(f"unsupported device {masks.device}")
    out = torch.empty_like(masks)
    fn = build.load("par_diffuse")
    build.check(fn(masks.data_ptr(), aff.data_ptr(), offsets.data_ptr(),
                   out.data_ptr(), b, c, h, w, k,
                   torch.cuda.current_stream(masks.device).cuda_stream),
                "par_diffuse")
    par_diffuse.launches += 1
    return out


par_diffuse.launches = 0
