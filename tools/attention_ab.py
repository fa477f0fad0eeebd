#!/usr/bin/env python3
"""Time the port's attention kernels, alone or against another tree's.

    python3 tools/attention_ab.py                      # this tree, times
    python3 tools/attention_ab.py --check              # chip_smoke's checks
    python3 tools/attention_ab.py --ab work_dirs/parent

Needs one NVIDIA GPU and nvcc; imports `excel_tpu_torch` (never jax) from
`--tree` (default: the repository this file lies in). `--ab OTHER` runs the
timing in four subprocesses on the same card in turns (OTHER, this tree, this
tree, OTHER; each builds its own kernels) and prints one table: per case
the two trees' CUDA-event medians (the lower of a tree's two turns) and
their ratio. The cases are the main paths' shapes (H=12, D=64): the LAM eval
batch (N=401, B=16: plain none and out, surgery acc), the calibrated train
step's pass (surgery none, N=401, B=4) and the MSC batch's token counts at
2 x 4 images (none, N = 197, 577, 901), in fp32 and bf16; for plain
attention without weights `scaled_dot_product_attention` is timed beside
the kernel as a yardstick (the port never calls it).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADS, HEAD_DIM = 12, 64
# (kernel, mode, N, B)
CASES = [("plain", "none", 401, 16), ("plain", "out", 401, 16),
         ("surgery", "acc", 401, 16), ("surgery", "none", 401, 4),
         ("plain", "none", 197, 8), ("surgery", "none", 197, 8),
         ("plain", "none", 577, 8), ("surgery", "none", 577, 8),
         ("plain", "none", 901, 8), ("surgery", "none", 901, 8)]


def _event_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _call(ak, kind, mode, q, k, v, acc):
    if kind == "plain":
        return ak.fused_plain_attention(q, k, v, acc=acc,
                                        need_weights=mode != "none")
    return ak.fused_surgery_attention(q, k, v, acc=acc,
                                      need_attn=mode != "none")


def run_times(tree: str, reps: int) -> dict:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, tree)
    from excel_tpu_torch import build
    from excel_tpu_torch.models import attention_kernels as ak

    build.build(("attention_plain", "attention_surgery"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for kind, mode, n, b in CASES:
            q, k, v = (torch.randn((b, HEADS, n, HEAD_DIM), device="cuda",
                                   generator=gen).to(dtype) for _ in range(3))
            acc = (torch.rand((b, n, n), device="cuda", generator=gen)
                   if mode == "acc" else None)
            name = f"{kind} {mode} N={n} B={b} {tag}"
            out[name] = _event_ms(
                torch, lambda: _call(ak, kind, mode, q, k, v, acc), reps)
            if (kind, mode) == ("plain", "none"):
                out[name + " sdpa"] = _event_ms(
                    torch, lambda: F.scaled_dot_product_attention(q, k, v),
                    reps)
    return out


def run_check(tree: str) -> None:
    """The attention part of `chip_smoke.py`'s kernel phase alone: both
    kernels against their plain versions at the main paths' shapes and at
    ragged token counts, every mode, fp32 and bf16, two launches bit for
    bit; prints the compiler's resource report first."""
    import torch

    sys.path.insert(0, tree)
    import chip_smoke
    from excel_tpu_torch import build

    chip_smoke.phase_environment()
    build.build(("attention_plain", "attention_surgery"))
    for name in ("attention_plain", "attention_surgery"):
        with open(build.library_path(name) + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"build[{name}]: {line.strip()}", flush=True)
    for seed, dtype in enumerate((torch.float32, torch.bfloat16)):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        chip_smoke.check_attention(gen, dtype)
    print("check passed", flush=True)


def run_ab(other: str, tree: str, reps: int) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = {other: [], tree: []}
    for which in (other, tree, tree, other):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", which,
             "--reps", str(reps), "--json"], capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stdout + res.stderr)
            raise SystemExit(f"timing run of {which} failed")
        runs[which].append(json.loads(res.stdout.strip().splitlines()[-1]))
    print(f"| case | {other} ms | {tree} ms | ratio |")
    print("| --- | --- | --- | --- |")
    for name in runs[tree][0]:
        a = min(r[name] for r in runs[other])
        c = min(r[name] for r in runs[tree])
        print(f"| {name} | {a:.4f} | {c:.4f} | {a / c:.2f} |", flush=True)
    print(json.dumps({"card": smi, "runs": runs}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--ab", metavar="OTHER")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    if args.ab:
        run_ab(os.path.abspath(args.ab), tree, args.reps)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.check:
        run_check(tree)
        return 0
    times = run_times(tree, args.reps)
    if args.json:
        print(json.dumps(times))
    else:
        for name, ms in times.items():
            print(f"{name}: {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
