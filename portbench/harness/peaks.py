"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit)."""
from __future__ import annotations

BYTES_PER_S = 3.35e12
FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
         "float32": 67e12, "float8": 1979e12}


def matmul_peak(compute_dtype: str) -> float:
    """The peak of the matrix products of a compute type (float32 runs
    with TF32 off, outside the tensor cores)."""
    return FLOPS[compute_dtype]


def bound_s(flops: float, nbytes: float, peak_flops: float):
    """(least seconds, which bound): the larger of FLOPs over the peak and
    bytes over the bandwidth."""
    t_ops, t_bytes = flops / peak_flops, nbytes / BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
