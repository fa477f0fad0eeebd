"""Profiling and benchmarking helpers (the port's counterpart of
excel_tpu/utils/profiling.py).

- `trace(logdir)`: context manager around `torch.profiler` that writes a
  Chrome trace (`trace.json`, loadable in chrome://tracing or Perfetto) of
  the host ops and, on a CUDA device, the device's kernels.
- `benchmark(fn, *args)`: per-call milliseconds of `fn`, timed with CUDA
  events on the card (the device's time from the first to the last call,
  on the current stream) and with `time.perf_counter` on the CPU.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; on exit write `<logdir>/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _on_cuda(out) -> bool:
    """Whether `out` (a tensor or a nest of them) holds a CUDA tensor."""
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return any(_on_cuda(x) for x in out)
    return False


def benchmark(fn: Callable, *args, iters: int = 8, warmup: int = 2) -> dict:
    """Time `fn(*args)`. Returns {"ms": per-call milliseconds,
    "calls_per_s": 1/s, "clock": "cuda" or "host"}: CUDA events when the
    warm-up's output is on a CUDA device, else the host clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if _on_cuda(out):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        ms, clock = start.elapsed_time(end) / iters, "cuda"
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        ms, clock = (time.perf_counter() - t0) * 1e3 / iters, "host"
    return {"ms": ms, "calls_per_s": 1e3 / ms, "clock": clock}
