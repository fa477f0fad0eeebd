#!/usr/bin/env python3
"""Time the port's attention kernels, alone or against another tree's.

    python3 tools/attention_ab.py                      # this tree, times
    python3 tools/attention_ab.py --check              # chip_smoke's checks
    python3 tools/attention_ab.py --ab work_dirs/parent

Needs one NVIDIA GPU and nvcc; imports `excel_tpu_torch` (never jax) from
`--tree` (default: the repository this file lies in). `--ab OTHER` runs the
timing in four subprocesses on the same card in turns (OTHER, this tree, this
tree, OTHER; each builds its own kernels) and prints one table: per case
the two trees' CUDA-event medians (the lower of a tree's two turns), their
ratio, the case's bound_ms and whether both trees' outputs have the same
bits (a digest of every output). The cases are the main paths' shapes
(H=12, D=64): the LAM eval batch (N=401, B=16: plain none and out, surgery
acc), the calibrated train step's pass (surgery none, N=401, B=4) and the
MSC batch's token counts at 2 x 4 images (none, N = 197, 577, 901); and
OpenCLIP ViT-H/14's (H=16, D=80) at its sweep's N=577, B=4 in every mode,
surgery with ex too, and SigLIP So400m/14's (H=16, D=72) at N=729, B=4 in
every mode (a tree without a head dim's kernels leaves its cases out); in
fp32 and bf16. For plain attention without weights
`scaled_dot_product_attention` is timed beside the kernel as a yardstick
(the port never calls it).

    python3 tools/attention_ab.py --digests      # JSON: DIGEST_CASES' bits

`--digests` prints the digests of DIGEST_CASES (D = 32, 64 and 80, every
mode, inputs drawn on the CPU from a seed; a context hashed in its [B, H,
N, D] order): tests/torch_fixtures/attention_digests.json holds them as the
kernels gave them, D = 32 and 64 before D = 80 came, D = 80 before the
contexts were stored token-major, and the card's tests hold today's
kernels to them.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (kernel, mode, N, B, heads, head dim, with ex)
CASES = [("plain", "none", 401, 16, 12, 64, False),
         ("plain", "out", 401, 16, 12, 64, False),
         ("surgery", "acc", 401, 16, 12, 64, False),
         ("surgery", "none", 401, 4, 12, 64, False),
         ("plain", "none", 197, 8, 12, 64, False),
         ("surgery", "none", 197, 8, 12, 64, False),
         ("plain", "none", 577, 8, 12, 64, False),
         ("surgery", "none", 577, 8, 12, 64, False),
         ("plain", "none", 901, 8, 12, 64, False),
         ("surgery", "none", 901, 8, 12, 64, False)]
# OpenCLIP ViT-H/14 at 336 px: the sweep's batch of 4 at 577 tokens
CASES += [("plain", m, 577, 4, 16, 80, False) for m in ("none", "out", "acc")]
CASES += [("surgery", m, 577, 4, 16, 80, False)
          for m in ("acc", "out", "none")]
CASES += [("surgery", "none", 577, 4, 16, 80, True)]
# SigLIP So400m/14 at 378 px: the sweep's batch of 4 at 729 tokens, 16
# heads of 72
CASES += [("plain", m, 729, 4, 16, 72, False) for m in ("none", "out", "acc")]
CASES += [("surgery", m, 729, 4, 16, 72, False)
          for m in ("acc", "out", "none")]
# the bits D = 32, 64 and 80 must keep: every mode, ragged N, ex
DIGEST_CASES = [(kind, mode, 197, 2, heads, d, ex)
                for d, heads in ((32, 3), (64, 12), (80, 4))
                for kind in ("plain", "surgery")
                for mode in ("none", "out", "acc")
                for ex in ((False, True) if kind == "surgery" else (False,))]
PEAK = {"fp32": 67e12, "bf16": 989e12}   # dense, H100 SXM, 700 W
BYTES_PER_S = 3.35e12


def case_name(case, tag) -> str:
    kind, mode, n, b, heads, d, ex = case
    return (f"{kind} {mode}{' ex' if ex else ''} N={n} B={b} H={heads} "
            f"D={d} {tag}")


def case_inputs(torch, case, dtype, seed: int):
    """q, k, v, acc, ex of a case on the card, drawn on the CPU from `seed`
    (the same values on every card and version of the kernels)."""
    kind, mode, n, b, heads, d, with_ex = case
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, heads, n, d), generator=g).to(dtype).cuda()
               for _ in range(3))
    acc = torch.rand((b, n, n), generator=g).cuda() if mode == "acc" \
        else None
    ex = ((torch.rand((b, n, n), generator=g) / n).to(dtype).float().cuda()
          if with_ex else None)
    return q, k, v, acc, ex


def bound_ms(case, dtype_tag) -> float:
    """The larger of the products at the type's peak (2 a head for plain
    attention, 5 for surgery, 2 N^2 D each) and q, k, v and the context
    read or written once with the fp32 [B, N, N] outputs (weights, the
    accumulator read, surgery's shared mix and ex)."""
    kind, mode, n, b, heads, d, with_ex = case
    el = 4 if dtype_tag == "fp32" else 2
    nn = b * n * n * 4
    flops = (2 if kind == "plain" else 5) * 2.0 * n * n * d * heads * b
    nbytes = 4.0 * b * heads * n * d * el \
        + {"none": 0, "out": nn, "acc": 2 * nn}[mode]
    if kind == "surgery":
        nbytes += nn + (nn if with_ex else 0)
    return 1e3 * max(flops / PEAK[dtype_tag], nbytes / BYTES_PER_S)


def digest(torch, outputs) -> str:
    h = hashlib.sha256()
    for t in outputs:
        if t is not None:
            h.update(t.detach().contiguous().view(torch.uint8).cpu()
                     .numpy().tobytes())
    return h.hexdigest()[:16]


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


def _call(ak, kind, mode, q, k, v, acc, ex=None):
    if kind == "plain":
        return ak.fused_plain_attention(q, k, v, acc=acc,
                                        need_weights=mode != "none")
    return ak.fused_surgery_attention(q, k, v, ex_attn=ex, acc=acc,
                                      need_attn=mode != "none")


def _build(tree: str):
    sys.path.insert(0, tree)
    from excel_tpu_torch import build
    from excel_tpu_torch.models import attention_kernels as ak

    build.build(("attention_plain", "attention_surgery"))
    return ak


def output_digests(torch, ak, cases) -> dict:
    """{case name: digest of its outputs} (a fresh accumulator a launch),
    None where the tree's kernels refuse the case's head dim."""
    out = {}
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for i, case in enumerate(cases):
            q, k, v, acc, ex = case_inputs(torch, case, dtype, i)
            try:
                got = _call(ak, case[0], case[1], q, k, v, acc, ex)
            except ValueError:
                got = None
            torch.cuda.synchronize()
            out[case_name(case, tag)] = None if got is None \
                else digest(torch, got)
    return out


def run_times(tree: str, reps: int) -> dict:
    import torch
    import torch.nn.functional as F

    ak = _build(tree)
    out = {}
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for i, case in enumerate(CASES):
            kind, mode, n, b, heads, d, _ = case
            q, k, v, acc, ex = case_inputs(torch, case, dtype, 1000 + i)
            name = case_name(case, tag)
            if d not in ak._KERNEL_HEAD_DIMS:
                out[name] = None
                continue
            got = _call(ak, kind, mode, q, k, v,
                        None if acc is None else acc.clone(), ex)
            out[name + " digest"] = digest(torch, got)
            out[name] = _event_ms(
                torch, lambda: _call(ak, kind, mode, q, k, v, acc, ex), reps)
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
    print(f"| case | {other} ms | {tree} ms | ratio | bound ms | "
          f"same bits |")
    print("| --- | --- | --- | --- | --- | --- |")
    bounds = {case_name(c, tag): bound_ms(c, tag) for c in CASES
              for tag in ("fp32", "bf16")}
    for name in runs[tree][0]:
        if name.endswith(" digest"):
            continue
        times = [[r[name] for r in runs[w] if r.get(name) is not None]
                 for w in (other, tree)]
        a, c = (f"{min(t):.4f}" if t else "-" for t in times)
        ratio = f"{min(times[0]) / min(times[1]):.2f}" \
            if all(times) else "-"
        digests = {r.get(name + " digest") for w in (other, tree)
                   for r in runs[w]} - {None}
        same = "" if name.endswith(" sdpa") or not all(times) \
            else ("yes" if len(digests) == 1 else "NO")
        bound = bounds.get(name)
        print(f"| {name} | {a} | {c} | {ratio} | "
              f"{'' if bound is None else f'{bound:.4f}'} | {same} |",
              flush=True)
    print(json.dumps({"card": smi, "runs": runs}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--ab", metavar="OTHER")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--digests", action="store_true")
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
    if args.digests:
        print(json.dumps(output_digests(torch, _build(tree), DIGEST_CASES),
                         indent=1))
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
