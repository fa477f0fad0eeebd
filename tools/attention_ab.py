#!/usr/bin/env python3
"""Time the port's attention kernels, alone or against another tree's.

    python3 tools/attention_ab.py                      # this tree, times
    python3 tools/attention_ab.py --check              # chip_smoke's checks
    python3 tools/attention_ab.py --ab work_dirs/parent

Needs one NVIDIA GPU and nvcc; imports `excel_tpu_torch` (never jax) from
`--tree` (default: the repository this file lies in). `--ab OTHER` runs the
timing in four subprocesses on the same card in turns (OTHER, this tree, this
tree, OTHER; each builds its own kernels) and prints three tables. First,
per case, the two trees' CUDA-event medians of a whole call (the lower of a
tree's two turns), their ratio, the case's bound_ms and whether both trees'
outputs have the same bits (a digest of every output). Then the rows kernel
and the sums kernel apart, each a call's profiler device time over the same
launches, the sums kernel beside its floors (`sums_floor_ms`). Last, each
tree's sums kernel at every bf16 case: the instantiation, its registers and
spill bytes (the compiler's -Xptxas -v report kept beside the library), its
shared memory and threads a block, its grid (all from the profiler's trace),
and from those the blocks and warps resident an SM and the waves a launch
takes. The cases are the main paths' shapes (H=12, D=64): the LAM eval
batch (N=401, B=16: plain none and out, surgery acc), the benchmark's sweep
batch (N=401, B=4: plain out, surgery acc), the calibrated train step's
pass (surgery none, N=401, B=4) and the MSC batch's token counts at 2 x 4
images (none, N = 197, 577, 901); OpenCLIP ViT-H/14's (H=16, D=80) at its
sweep's N=577, B=4 in every mode, surgery with ex too, EVA02-CLIP-L/14's
(H=16, D=64) at the same N and B (plain out, surgery acc) and SigLIP
So400m/14's (H=16, D=72) at N=729, B=4 in every mode (a tree without a head
dim's kernels leaves its cases out); in fp32 and bf16. For plain attention
without weights `scaled_dot_product_attention` is timed beside the kernel as
a yardstick (the port never calls it).

    python3 tools/attention_ab.py --digests      # JSON: DIGEST_CASES' bits

`--digests` prints the digests of DIGEST_CASES (D = 32, 64, 72 and 80, every
mode, and one case a width whose sums kernel takes several waves; inputs
drawn on the CPU from a seed; a context hashed in its [B, H, N, D] order):
tests/torch_fixtures/attention_digests.json holds them as the kernels gave
them, D = 32 and 64 before D = 80 came, D = 80 before the contexts were
stored token-major, D = 72 and the several-wave cases before the sums kernel
was re-tiled for them, and the card's tests hold today's kernels to them.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

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
# the benchmark's sweep batch of 4: ViT-B/16 at 401 tokens and EVA02-CLIP-L/14
# at 577 (16 heads of 64), the pass's plain launch with weights and its
# surgery launches
CASES += [(kind, mode, n, 4, heads, 64, False)
          for n, heads in ((401, 12), (577, 16))
          for kind, mode in (("plain", "out"), ("surgery", "acc"))]
# the bits D = 32, 64 and 80 must keep: every mode, ragged N, ex
DIGEST_CASES = [(kind, mode, 197, 2, heads, d, ex)
                for d, heads in ((32, 3), (64, 12), (80, 4))
                for kind in ("plain", "surgery")
                for mode in ("none", "out", "acc")
                for ex in ((False, True) if kind == "surgery" else (False,))]
# appended (a case's inputs are drawn from its index): D = 72 as D = 80, and
# one case a width whose sums kernel takes several waves and ends on a
# ragged patch: each tower's sweep launch and msc's largest
DIGEST_CASES += [(kind, mode, 197, 2, 4, 72, ex)
                 for kind in ("plain", "surgery")
                 for mode in ("none", "out", "acc")
                 for ex in ((False, True) if kind == "surgery" else (False,))]
DIGEST_CASES += [("surgery", "acc", 577, 4, 16, 80, False),
                 ("surgery", "acc", 729, 4, 16, 72, False),
                 ("surgery", "acc", 401, 4, 12, 64, False),
                 ("surgery", "none", 901, 8, 12, 64, False)]
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


def sums_floor_ms(case, sm_count: int, sm_hz: float) -> tuple[float, str]:
    """The bf16 sums kernel's floor: the larger of its products at the
    tensor cores' peak (for each softmax it sums, 2 N^2 D a head: 4 in
    surgery with the head sums of q k^T, 3 without, 1 for plain weights),
    its exponentials (one a logit, softmax and head) on MUFU's 16 lanes an SM
    at the SM clock, and the fp32 [B, N, N] sums written once (with the
    accumulator and ex read once)."""
    kind, mode, n, b, heads, d, with_ex = case
    soft = 1 if kind == "plain" else (3 if mode == "none" else 4)
    nn = b * n * n * 4
    by = {"products": soft * 2.0 * n * n * d * heads * b / PEAK["bf16"],
          "exponentials": soft * b * heads * n * n / (16 * sm_count * sm_hz),
          "bytes": (nn * ((kind == "surgery") + (mode != "none")
                          + (mode == "acc") + with_ex)) / BYTES_PER_S}
    worst = max(by, key=by.get)
    return 1e3 * by[worst], worst


def sm_clock_hz() -> float:
    """The SM clock the card reports as its maximum (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    return float(out) * 1e6


def kernel_name(name: str) -> str:
    """`tc::sums_kernel<80, true, true, SumsSplit<1, 64, 2, 64, 1>>` of a
    kernel's name in a trace (namespaces inside the arguments dropped)."""
    m = re.search(r"(\w+)::(\w+_kernel)<", name)
    if not m:
        return name
    depth, i = 1, m.end()
    while i < len(name) and depth:
        depth += {"<": 1, ">": -1}.get(name[i], 0)
        i += 1
    inner = re.sub(r"\bexcel::(\w+::)?", "", name[m.end():i])
    return f"{m[1]}::{m[2]}<{inner}".replace("> >", ">>")


def _demangle(sym: str) -> str | None:
    """kernel_name's form of the mangled name of a template kernel in
    namespace `excel`, else None."""
    m = re.match(r"_ZN5excel(\d+)", sym)
    if not m:
        return None
    i = m.end()
    ns = sym[i:i + int(m[1])]
    m = re.match(r"(\d+)", sym[i + int(m[1]):])
    if not m:
        return None
    i += len(ns) + m.end()
    fn = sym[i:i + int(m[1])]
    rest = sym[i + int(m[1]):]

    def args(text):
        """(decoded arguments, the text after their closing E) of the
        text after an I: literals, and classes of this namespace (written
        out or as a substitution, S0_)."""
        out = []
        while text and text[0] != "E":
            lit = re.match(r"L([ib])(\d+)E", text)
            cls = re.match(r"N(?:S[0-9A-Z]*_|5excel\d+[a-z]+)(\d+)", text)
            if lit:
                out.append(lit[2] if lit[1] == "i"
                           else ("true" if lit[2] == "1" else "false"))
                text = text[lit.end():]
            elif cls:
                j = cls.end()
                name = text[j:j + int(cls[1])]
                if text[j + int(cls[1])] != "I":
                    return out, ""
                inner, text = args(text[j + int(cls[1]) + 1:])
                out.append(f"{name}<{', '.join(inner)}>")
                text = text[1:]  # the class's closing E
            else:
                return out, ""
        return out, text[1:]
    if not rest.startswith("I"):
        return f"{ns}::{fn}"
    vals, _ = args(rest[1:])
    return f"{ns}::{fn}<{', '.join(vals)}>"


def ptxas_report(log_path: str) -> dict:
    """{kernel: registers, spill stores and loads, stack frame} from the
    compiler's -Xptxas -v report that the build keeps beside a library."""
    out, cur = {}, None
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = _demangle(m[1])
                if cur is not None:
                    out[cur] = {}
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                out[cur].update(stack=int(m[1]), spill_stores=int(m[2]),
                                spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[cur]["registers"] = int(m[1])
    return out


def residency(regs: int, smem: int, threads: int) -> int:
    """Blocks resident an SM of an H100 (compute capability 9.0): 64 warps,
    32 blocks, 65,536 registers in 256-register units a warp, 228 KB of
    shared memory with 1 KB kept for each block."""
    warps = (threads + 31) // 32
    per_warp = -(-regs * 32 // 256) * 256
    return min(64 // warps, 32, 65536 // per_warp // warps,
               233472 // (smem + 1024))


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


def _kernel_ms(torch, fn, reps) -> dict:
    """{kernel: [device ms a call, launch args]} over `reps` calls of fn,
    from the profiler's trace (its kernel events carry the grid, the block,
    the registers and the shared memory)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    out = {}
    for ev in events:
        if ev.get("cat") != "kernel":
            continue
        rec = out.setdefault(kernel_name(ev.get("name", "")),
                             [0.0, ev.get("args", {})])
        rec[0] += ev.get("dur", 0) / 1e3 / reps
    return out


def run_times(tree: str, reps: int) -> dict:
    """{"times": whole calls' event ms, "digests", "kernels": the rows and
    sums kernels' device ms a call and the sums kernel's launch (bf16),
    "resources": the compiler's report of every kernel}."""
    import torch
    import torch.nn.functional as F

    ak = _build(tree)
    from excel_tpu_torch import build

    res = {"times": {}, "digests": {}, "kernels": {}, "resources": {}}
    for lib in ("attention_plain", "attention_surgery"):
        res["resources"].update(ptxas_report(build.library_path(lib)
                                             + ".log"))
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for i, case in enumerate(CASES):
            kind, mode, n, b, heads, d, _ = case
            q, k, v, acc, ex = case_inputs(torch, case, dtype, 1000 + i)
            name = case_name(case, tag)
            if d not in ak._KERNEL_HEAD_DIMS:
                res["times"][name] = None
                continue
            got = _call(ak, kind, mode, q, k, v,
                        None if acc is None else acc.clone(), ex)
            res["digests"][name] = digest(torch, got)

            def call():
                return _call(ak, kind, mode, q, k, v, acc, ex)
            res["times"][name] = _event_ms(torch, call, reps)
            rec = {}
            for kern, (ms, args) in _kernel_ms(torch, call, reps).items():
                role = kern.split("::")[-1].split("_kernel")[0]
                rec[role] = ms
                if role == "sums":
                    rec["sums_kernel"] = kern
                    rec["launch"] = {
                        key: args.get(key) for key in
                        ("grid", "block", "registers per thread",
                         "shared memory")}
            res["kernels"][name] = rec
            if (kind, mode) == ("plain", "none"):
                res["times"][name + " sdpa"] = _event_ms(
                    torch, lambda: F.scaled_dot_product_attention(q, k, v),
                    reps)
    return res


def launch_report(kernels: dict, resources: dict, sm_count: int) -> list:
    """Table rows of each bf16 case's sums kernel: instantiation, registers
    and spills, shared memory and threads a block, grid, resident blocks and
    warps an SM, waves."""
    rows = []
    for name, rec in kernels.items():
        launch = rec.get("launch")
        if not name.endswith("bf16") or not launch or not launch["grid"]:
            continue
        kern = rec["sums_kernel"]
        ptx = resources.get(kern, {})
        regs = launch["registers per thread"] or ptx.get("registers", 0)
        smem, block = launch["shared memory"], launch["block"]
        threads = block[0] * block[1] * block[2]
        grid = launch["grid"][0] * launch["grid"][1] * launch["grid"][2]
        per_sm = residency(regs, smem, threads)
        slots = sm_count * per_sm
        rows.append(
            f"| {name} | `{kern}` | {regs} | "
            f"{ptx.get('spill_stores', '?')} / {ptx.get('spill_loads', '?')}"
            f" | {smem} | {threads} | {grid} | {per_sm} | "
            f"{per_sm * threads // 32} | {grid / slots:.2f} "
            f"({-(-grid // slots)}) |")
    return rows


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
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    hz = sm_clock_hz()
    runs = {other: [], tree: []}
    for which in (other, tree, tree, other):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", which,
             "--reps", str(reps), "--json"], capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stdout + res.stderr)
            raise SystemExit(f"timing run of {which} failed")
        runs[which].append(json.loads(res.stdout.strip().splitlines()[-1]))

    def best(which, get):
        vals = [v for v in (get(r) for r in runs[which]) if v is not None]
        return min(vals) if vals else None

    def cell(x):
        return "-" if x is None else f"{x:.4f}"

    def ratio(a, c):
        return "-" if a is None or c is None or not c else f"{a / c:.2f}"

    print(f"| case | {other} ms | {tree} ms | ratio | bound ms | "
          f"same bits |")
    print("| --- | --- | --- | --- | --- | --- |")
    bounds = {case_name(c, tag): bound_ms(c, tag) for c in CASES
              for tag in ("fp32", "bf16")}
    for name in runs[tree][0]["times"]:
        a, c = (best(w, lambda r: r["times"].get(name))
                for w in (other, tree))
        digests = {r["digests"].get(name) for w in (other, tree)
                   for r in runs[w]} - {None}
        same = "" if name.endswith(" sdpa") or a is None or c is None \
            else ("yes" if len(digests) == 1 else "NO")
        bound = bounds.get(name)
        print(f"| {name} | {cell(a)} | {cell(c)} | {ratio(a, c)} | "
              f"{'' if bound is None else f'{bound:.4f}'} | {same} |",
              flush=True)
    print(f"\n| case | rows {other} | rows {tree} | sums {other} | "
          f"sums {tree} | sums ratio | sums floor ms |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    cases = {case_name(c, tag): c for c in CASES
             for tag in ("fp32", "bf16")}
    for name in runs[tree][0]["kernels"]:
        ra, rc, sa, sc = (best(w, lambda r: r["kernels"].get(name, {})
                               .get(role))
                          for role in ("rows", "sums")
                          for w in (other, tree))
        floor = ""
        if name.endswith("bf16") and sc is not None:
            ms, by = sums_floor_ms(cases[name], sm_count, hz)
            floor = f"{ms:.4f} ({by})"
        print(f"| {name} | {cell(ra)} | {cell(rc)} | {cell(sa)} | "
              f"{cell(sc)} | {ratio(sa, sc)} | {floor} |", flush=True)
    for which in (other, tree):
        print(f"\nsums kernel of {which} ({sm_count} SMs):\n"
              "| case | kernel | registers | spill stores / loads (bytes) | "
              "shared memory a block (bytes) | threads | grid | blocks an SM"
              " | warps an SM | waves |\n"
              "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
        for row in launch_report(runs[which][0]["kernels"],
                                 runs[which][0]["resources"], sm_count):
            print(row, flush=True)
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
    res = run_times(tree, args.reps)
    if args.json:
        print(json.dumps(res))
        return 0
    for name, ms in res["times"].items():
        kern = res["kernels"].get(name, {})
        split = "".join(f" {role} {kern[role]:.4f}" for role in
                        ("rows", "sums") if role in kern)
        print(f"{name}: {'-' if ms is None else f'{ms:.4f}'} ms{split}")
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    for row in launch_report(res["kernels"], res["resources"], sm_count):
        print(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
