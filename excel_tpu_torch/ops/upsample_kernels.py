"""The seg loss's upsample: the CUDA backward and its plain version.

`upsample_linear` (ops/labels.py) upsamples the head's logits by an integer
factor with `F.interpolate(bilinear, align_corners=False)`. Its forward is
PyTorch's; its backward is `upsample_linear_backward`, a gather
(csrc/upsample_linear.cu), in place of PyTorch's scatter with atomics. No
Pallas kernel corresponds: the JAX package leaves `jax.image.resize`'s
gradient to XLA.

The map is separable: output index o samples its input at
src = max(in / out * (o + 0.5) - 0.5, 0), taps (int)src and the next one
(the last held at the edge) with weights 1 - l and l, l = src - (int)src,
in fp32 as the forward computes them; so
grad_in = Wy^T . grad_out . Wx with two nonzeros in each row of Wy and Wx.

On CPU tensors the backward computes its plain version (two einsums with
those matrices); on CUDA tensors it launches the kernel through
`build.launch` or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .. import build


def linear_taps(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """[n_out, n_in] float32: row o holds the forward's two weights of
    output index o at its two input taps (their sum where the edge makes
    them one)."""
    scale = torch.tensor(n_in, dtype=torch.float32) / n_out
    o = torch.arange(n_out, dtype=torch.float32)
    src = torch.clamp(scale * (o + 0.5) - 0.5, min=0.0)
    i0 = src.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    l1 = src - i0.to(torch.float32)
    rows = torch.arange(n_out)
    m = torch.zeros((n_out, n_in), dtype=torch.float32)
    m.index_put_((rows, i0), 1.0 - l1, accumulate=True)
    m.index_put_((rows, i1), l1, accumulate=True)
    return m.to(device)


def upsample_linear_backward_reference(grad_out: torch.Tensor,
                                       in_hw: tuple[int, int]) -> torch.Tensor:
    """Plain version of `upsample_linear_backward`."""
    h, w = in_hw
    big_h, big_w = grad_out.shape[-2:]
    wy = linear_taps(h, big_h, grad_out.device)
    wx = linear_taps(w, big_w, grad_out.device)
    t = torch.einsum("...yx,xj->...yj", grad_out, wx)
    return torch.einsum("...yj,yi->...ij", t, wy)


def upsample_linear_backward(grad_out: torch.Tensor,
                             in_hw: tuple[int, int]) -> torch.Tensor:
    """The gradient of `F.interpolate(x, grad_out.shape[-2:], bilinear,
    align_corners=False)` with respect to x [B, C, *in_hw], for integer
    factors: grad_out [B, C, H, W] float32 -> [B, C, h, w] float32."""
    h, w = in_hw
    if (grad_out.dim() != 4 or grad_out.dtype != torch.float32
            or grad_out.shape[2] % h or grad_out.shape[3] % w):
        raise ValueError(f"upsample_linear_backward: grad_out "
                         f"{tuple(grad_out.shape)} {grad_out.dtype} is not "
                         f"an integer upsample of {in_hw} in float32")
    if grad_out.device.type == "cpu":
        return upsample_linear_backward_reference(grad_out, in_hw)
    if grad_out.device.type != "cuda":
        raise ValueError(f"upsample_linear_backward: unsupported device "
                         f"{grad_out.device}")
    g = grad_out.contiguous()
    b, c, big_h, big_w = g.shape
    out = g.new_empty((b, c, h, w))
    build.launch("excel_upsample_linear_bwd_f32", g, g.data_ptr(),
                 out.data_ptr(), b * c, h, w, big_h, big_w)
    return out


class UpsampleLinear(torch.autograd.Function):
    """`F.interpolate(x, out_hw, bilinear, align_corners=False)` of a
    float32 x [B, C, h, w] whose backward is `upsample_linear_backward`."""

    @staticmethod
    def forward(ctx, x, out_hw):
        ctx.in_hw = tuple(x.shape[-2:])
        return F.interpolate(x, size=out_hw, mode="bilinear",
                             align_corners=False)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        return upsample_linear_backward(grad, ctx.in_hw), None
