#!/usr/bin/env python3
"""Time the seg loss's upsample backward on the card.

    python3 tools/upsample_times.py

Needs one NVIDIA GPU and nvcc; imports `excel_tpu_torch` (never jax) from
the repository this file lies in. At the fast train step's logits
[4, 21, 20, 20] -> [4, 21, 320, 320] (VOC) and [4, 81, 28, 28] -> 448
(COCO), each an fp32 gradient, it prints per call the device time
(torch.profiler, every kernel of the call, over `--reps` calls after a
warm-up) of:

- `kernel`: `upsample_linear_backward`, csrc/upsample_linear.cu;
- `plain`: its plain version (two einsums with the tap matrices, the
  matrices built each call) run on the card, TF32 off;
- `library`: PyTorch's `upsample_bilinear2d_backward` (a zero fill and
  the scatter with atomics), timed only: the port does not call it;

and `bound_ms`, the gradient read once and the input gradient written once
over 3.35 TB/s; then the kernel's register and spill report from ptxas.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_S = 3.35e12
# name -> (B, C, h, w, H, W)
CASES = {"train VOC": (4, 21, 20, 20, 320, 320),
         "train COCO": (4, 81, 28, 28, 448, 448)}


def device_ms(torch, fn, reps: int) -> float:
    """Device time of one call's kernels (torch.profiler) over `reps`
    calls after a warm-up, without the host's gaps between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / reps / 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("upsample_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from excel_tpu_torch import build
    from excel_tpu_torch.ops import upsample_kernels as uk

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (b, c, h, w, big_h, big_w) in CASES.items():
        g = torch.randn((b, c, big_h, big_w), device="cuda", generator=gen)
        nbytes = (g.numel() + b * c * h * w) * 4
        times = {
            "kernel": device_ms(torch, lambda: uk.upsample_linear_backward(
                g, (h, w)), args.reps),
            "plain": device_ms(
                torch, lambda: uk.upsample_linear_backward_reference(
                    g, (h, w)), max(args.reps // 5, 3)),
            "library": device_ms(
                torch, lambda: torch.ops.aten.upsample_bilinear2d_backward(
                    g, [big_h, big_w], [b, c, h, w], False), args.reps),
        }
        bound = nbytes / HBM_BYTES_S * 1e3
        print(f"{name} [{b}, {c}, {h}, {w}] -> [{big_h}, {big_w}]: "
              + " ".join(f"{k}_ms={v:.4f}" for k, v in times.items())
              + f" bound_ms={bound:.4f} (bytes {nbytes})"
              + f" kernel/bound={times['kernel'] / bound:.2f}", flush=True)
    with open(build.library_path("upsample_linear") + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print(f"ptxas: {line.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
