"""PyTorch and CUDA port of excel_tpu for NVIDIA Hopper.

The JAX package `excel_tpu` is the reference. This package keeps its
module names and public layouts (NHWC images, [B, H, N, D] q/k/v,
[B, C, H, W] maps) and replaces its Pallas kernels with CUDA kernels built
from `csrc/` (see `build.py`). It imports neither jax nor excel_tpu.
Entry points run on the GPU unless the caller passes device="cpu".
"""
