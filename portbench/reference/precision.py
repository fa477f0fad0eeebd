"""Operand rounding of the reference: float32 (none), bfloat16, float8.

A matrix product of the reference rounds both operands with `mm` and sums
in float32, as a bfloat16 or float8 GEMM does on the card. PAR rounds its
affinities and masks with `store` after each step, as its storage type
would. Float8 is e4m3 with one scale a tensor (its largest magnitude to
448), the usual inference recipe.
"""
from __future__ import annotations

import torch

_E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    def __init__(self, name: str = "float32"):
        if name not in ("float32", "bfloat16", "float8"):
            raise ValueError(f"unknown precision {name}")
        self.name = name

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x.float()
        if self.name == "bfloat16":
            return x.to(torch.bfloat16).float()
        return _fp8(x)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.round(a), self.round(b))

    store = round


FP32 = Precision("float32")


def exact_matmuls() -> None:
    """float32 products in float32 on the card: no TF32."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
