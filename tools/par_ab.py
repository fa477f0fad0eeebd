#!/usr/bin/env python3
"""Time the port's PAR kernels, alone or against another tree's.

    python3 tools/par_ab.py                      # this tree, times
    python3 tools/par_ab.py --check              # bit-for-bit checks
    python3 tools/par_ab.py --ab work_dirs/parent

Needs one NVIDIA GPU and nvcc; imports `excel_tpu_torch` (never jax) from
`--tree` (default: the repository this file lies in). Two sources:

- `csrc/par_diffuse_valid.cu`: the step entry point (Pallas rows 7 and 6)
  and the resident one (row 9, 20 steps in one launch). Cases, K=48
  offsets (dilations 1, 2, 4, 8, 12, 24; pad 24): the fast LAM eval
  batch's [16, C, 440, 640] canvas with `chip_smoke.py`'s valid extents at
  C=4 (the sweep's 3-slot bucket) and at C=7 and 13 (slot buckets 6 and
  12, which run 2 and 3 channel passes), the train step's [4, C, 376, 384]
  canvas at full 320 x 320 extents with C=5 (VOC) and C=9 (COCO), and a
  barrier probe: one 8 x 64 image per SM, so that the resident launch's 20
  steps are mostly its 19 grid barriers; `(resident - step) / 19` bounds
  one barrier's cost from above. A step moves the valid pixels'
  affinities, the canvas in and the canvas out. 20 steps move 20 such
  steps where the affinity stack exceeds the 50 MiB L2 (the eval shape);
  where it fits (the train shape), they move the stack once and 20
  canvases in and out.
- `csrc/par_diffuse.cu` (`par_diffuse`, one step over unpadded masks,
  Pallas rows 5 and 8): the fp32 PAR step of the LAM eval batch [16, 4,
  384, 512] on masks replicated from `chip_smoke.py`'s valid extents, K=48;
  row 8, the fp32 train step's full-extent step, at [4, 5|9, 320, 320],
  K=48; the CRF's message pass at [4, 21, 384, 512] (VOC, the MSC batch)
  and [2, 81, 480, 640] (COCO), K=72 (dilations 1 ... 55, pad 55), fp32 and
  bf16. A step moves the affinities, the masks in and out; its operations
  floor is 64 products an SM and clock (the SM clock `nvidia-smi` reports
  as its maximum): fp32 needs one FMUL and one FADD a product on 128
  lanes, bf16 one fp32 add and one bf16 -> fp32 placement, the placement
  on the 64-lane integer pipe (the issue floor). The bound is the larger
  of the two.

- `csrc/par_pad_clamp.cu` and `csrc/par_affinity.cu` (`pad_replicate_valid`
  and `par_affinity`, Pallas rows 10 and 11): the fast LAM eval batch's
  fp32 images [16, 3, 384, 512] and bf16 masks [16, 4, 384, 512] with
  `chip_smoke.py`'s valid extents, and the fast train step's [4, 3, 320,
  320] and [4, 5, 320, 320] at full extents, pad-clamped at pad 24, and the
  affinity (K=48) of each padded image. Pad-clamp moves its input and
  output once; the affinity's bound is the largest of its bytes (the padded
  image, the bf16 stack), its fp32 instructions on 128 lanes an SM and its
  MUFU instructions on 16, both counted a pixel in the kernel's SASS
  (`chip_smoke.affinity_sass_counts`). `--check` holds pad-clamp bit for
  bit and the affinity within one bf16 ulp of their plain versions (and
  prints how many affinities differ from it) and prints the SASS counts;
  each run prints a digest of each case's output bytes, and `--ab` fails
  where the two trees' digests differ. These cases' times are the
  kernels' device time (torch.profiler), without the host's gaps, which
  exceed a 5-microsecond pad-clamp.

Times are CUDA-event medians of samples of 10 calls back to back. `--ab
OTHER` runs the timing in four subprocesses on the same card in turns
(OTHER, this tree, this tree, OTHER; each builds its own kernels) and
prints one table: per case the two trees' medians (the lower of a tree's
two turns), their ratio, and `bound_ms`, the bytes a call must move over
3.35 TB/s (or the operations floor, where larger).
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
DILATIONS = (1, 2, 4, 8, 12, 24)
PAD, ITERS = 24, 20
PEAK_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20
EVAL_VALID = [[375, 500], [333, 500], [384, 512], [300, 450]] * 4
BARRIER = "barrier probe"
CRF_DILATIONS = (1, 2, 3, 5, 8, 13, 21, 34, 55)
# par_diffuse cases: name -> (dtype name, dilations, B, C, h, w, valid
# extents to replicate the masks from, or None)
DIFFUSE_CASES = {
    "row5 PAR fp32 [16, 4, 384, 512]": ("float32", DILATIONS, 16, 4, 384,
                                        512, EVAL_VALID),
    "row8 fp32 [4, 5, 320, 320]": ("float32", DILATIONS, 4, 5, 320, 320,
                                   None),
    "row8 fp32 [4, 9, 320, 320]": ("float32", DILATIONS, 4, 9, 320, 320,
                                   None),
    "row5 CRF fp32 [4, 21, 384, 512]": ("float32", CRF_DILATIONS, 4, 21, 384,
                                        512, None),
    "row5 CRF bf16 [4, 21, 384, 512]": ("bfloat16", CRF_DILATIONS, 4, 21,
                                        384, 512, None),
    "row5 CRF fp32 [2, 81, 480, 640]": ("float32", CRF_DILATIONS, 2, 81, 480,
                                        640, None),
    "row5 CRF bf16 [2, 81, 480, 640]": ("bfloat16", CRF_DILATIONS, 2, 81,
                                        480, 640, None),
}
# rows 10 and 11: name -> (B, h, w, valid extents or None for full, mask
# channels)
PAR_INPUT_CASES = {"eval B=16": (16, 384, 512, EVAL_VALID, 4),
                   "train B=4": (4, 320, 320, None, 5)}
# name -> (B, C, h, w, valid extents or None for full); B=None: one image
# per SM
CASES = {"eval B=16 C=4": (16, 4, 384, 512, EVAL_VALID),
         "eval B=16 C=7": (16, 7, 384, 512, EVAL_VALID),
         "eval B=16 C=13": (16, 13, 384, 512, EVAL_VALID),
         "train B=4 C=5": (4, 5, 320, 320, None),
         "train B=4 C=9": (4, 9, 320, 320, None),
         BARRIER: (None, 1, 8, 64, None)}


def _event_ms(torch, fn, reps, inner=10):
    """Median over `reps` samples of one call's ms, a sample timing `inner`
    calls back to back between two CUDA events (so that the host's launch
    gaps do not enter the times of the short kernels)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _inputs(torch, pk, offsets, b, c, h, w, extents, seed):
    """The padded bf16 canvas, affinities, extents, and the bounds of one
    step and of ITERS resident steps."""
    if b is None:
        b = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(seed)
    valid = torch.tensor(extents or [[h, w]] * b, device="cuda",
                         dtype=torch.int32)
    masks = torch.rand((b, c, h, w), device="cuda", generator=gen)
    aff = torch.rand((b, len(offsets), h, w), device="cuda", generator=gen)
    aff = (aff / aff.sum(dim=1, keepdim=True)).bfloat16()
    mp = pk.pad_replicate_valid_reference(masks.bfloat16(), valid, PAD)
    valid_px = int((valid[:, 0] * valid[:, 1]).sum())
    aff_bytes, canvas_bytes = valid_px * len(offsets) * 2, 2 * mp.numel() * 2
    step_bytes = aff_bytes + canvas_bytes
    res_bytes = (aff_bytes + ITERS * canvas_bytes
                 if aff.numel() * 2 <= L2_BYTES else ITERS * step_bytes)
    return (mp, aff, valid, step_bytes / PEAK_BYTES_PER_S * 1e3,
            res_bytes / PEAK_BYTES_PER_S * 1e3)


def sm_clock_hz() -> float:
    """The SM clock the card reports as its maximum (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    return float(out) * 1e6


def diffuse_bound_ms(b, c, h, w, k, elem_bytes, sms, clock_hz):
    """(bound ms, what bounds it) of one `par_diffuse` step: the affinities
    and the masks in and out over 3.35 TB/s, or the operations, 64 products
    an SM and clock: fp32 takes one FMUL and one FADD a product (never
    contracted into an FMA) on 128 fp32 lanes, bf16 one bf16 -> fp32
    placement a product on the 64-lane integer pipe (the issue floor; its
    fp32 add runs beside it)."""
    nbytes = (b * k * h * w + 2 * b * c * h * w) * elem_bytes
    return max((nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"),
               (b * c * h * w * k / (sms * 64 * clock_hz) * 1e3,
                "operations"))


def _diffuse_inputs(torch, offsets_tensor, replicate, dtype, dil, b, c, h, w,
                    extents, seed):
    from excel_tpu_torch.ops.par import _offsets as par_offsets

    if dil == CRF_DILATIONS:
        from excel_tpu_torch.ops.crf_tpu import _offsets
        offs = _offsets(dil)
    else:
        offs = par_offsets(dil)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    masks = torch.rand((b, c, h, w), device="cuda", generator=gen)
    if extents is not None:
        masks = replicate(masks, torch.tensor(extents, device="cuda",
                                              dtype=torch.int32))
    aff = torch.rand((b, len(offs), h, w), device="cuda", generator=gen)
    aff = aff / aff.sum(dim=1, keepdim=True)
    dt = getattr(torch, dtype)
    return (masks.to(dt).contiguous(), aff.to(dt).contiguous(),
            offsets_tensor(offs, "cuda"))


def _chip_smoke():
    """This repository's chip_smoke.py (its bounds and tolerances), whichever
    tree is timed."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _par_input_cases(torch, pk, seed, bounds=True):
    """Rows 10 and 11: {case: (kernel call, plain call, (bound ms, what
    bounds it))}, the affinity's inputs padded by the plain version. The
    affinity's bound counts the instructions of this repository's kernel
    (the built library of the tree imported): without `bounds` (timing
    another tree), (None, None)."""
    from excel_tpu_torch.ops.par import _offsets, _pos_weight

    offs = _offsets(DILATIONS)
    pos_w = [float(p) for p in _pos_weight(DILATIONS)]
    cases = {}
    for name, (b, h, w, ext, c) in PAR_INPUT_CASES.items():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        valid = torch.tensor(ext or [[h, w]] * b, device="cuda",
                             dtype=torch.int32)
        images = torch.randn((b, 3, h, w), device="cuda", generator=gen)
        masks = torch.rand((b, c, h, w), device="cuda",
                           generator=gen).bfloat16()
        for what, x in (("images fp32", images), ("masks bf16", masks)):
            hp, wp = pk.padded_shape(h, w, PAD)
            nbytes = x.numel() * x.element_size() * (1 + hp * wp / (h * w))
            cases[f"row10 {what} {tuple(x.shape)} {name}"] = (
                lambda x=x, valid=valid: pk.pad_replicate_valid(x, valid, PAD),
                lambda x=x, valid=valid: pk.pad_replicate_valid_reference(
                    x, valid, PAD),
                (nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"))
        ip = pk.pad_replicate_valid_reference(images, valid, PAD)
        bound = (None, None)
        if bounds:
            ms, by, term, _ = _chip_smoke().affinity_bound_ms(
                b * h * w, ip.numel() * 4 + b * len(offs) * h * w * 2,
                len(offs))
            bound = (ms, f"{by}: {term}")
        cases[f"row11 affinity K={len(offs)} {tuple(ip.shape)} {name}"] = (
            lambda ip=ip, h=h, w=w: pk.par_affinity(ip, offs, pos_w, h, w),
            lambda ip=ip, h=h, w=w: pk.par_affinity_reference(
                ip, offs, pos_w, h, w),
            bound)
    return cases


def _device_ms(torch, fn, tag: str, reps: int) -> float:
    """Device time of one call's kernels whose name holds `tag`
    (torch.profiler), over `reps` calls after a warm-up: the kernel alone,
    without the host's gaps between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and tag in e.key)
    return us / reps / 1e3


def _digest(torch, t) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).cpu()
                          .numpy().tobytes()).hexdigest()[:16]


def _setup(tree):
    sys.path.insert(0, tree)
    from excel_tpu_torch import build
    from excel_tpu_torch.ops import par_kernels as pk
    from excel_tpu_torch.ops.par import _offsets

    build.build(("par_diffuse_valid", "par_diffuse", "par_pad_clamp",
                 "par_affinity"))
    return build, pk, _offsets(DILATIONS)


def run_times(tree: str, reps: int) -> dict:
    import torch

    _, pk, offsets = _setup(tree)
    out = {}
    for name, (b, c, h, w, ext) in CASES.items():
        mp, aff, valid, step_bound, res_bound = _inputs(
            torch, pk, offsets, b, c, h, w, ext, 0)
        out[f"{name} step"] = _event_ms(
            torch, lambda: pk.par_diffuse_padded_valid(
                mp, aff, valid, offsets, h, w), reps)
        out[f"{name} step bound"] = step_bound
        out[f"{name} resident x{ITERS}"] = _event_ms(
            torch, lambda: pk.par_diffuse_valid_resident(
                mp, aff, valid, offsets, h, w, ITERS), max(reps // 2, 3))
        out[f"{name} resident x{ITERS} bound"] = res_bound
        del mp, aff, valid
    out[f"{BARRIER} per barrier, at most"] = (
        out[f"{BARRIER} resident x{ITERS}"] - out[f"{BARRIER} step"]) / (
            ITERS - 1)
    from excel_tpu_torch.ops.par import _replicate_valid

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_hz()
    for name, (dtype, dil, b, c, h, w, ext) in DIFFUSE_CASES.items():
        masks, aff, offsets = _diffuse_inputs(
            torch, pk.offsets_tensor, _replicate_valid, dtype, dil, b, c, h,
            w, ext, 0)
        out[name] = _event_ms(
            torch, lambda: pk.par_diffuse(masks, aff, offsets), reps)
        out[f"{name} bound"] = diffuse_bound_ms(
            b, c, h, w, aff.shape[1], masks.element_size(), sms, clock)[0]
        del masks, aff
    cases = _par_input_cases(torch, pk, 0, bounds=tree == HERE)
    for name, (fn, _, (bound, by)) in cases.items():
        tag = "pad_clamp_kernel" if name.startswith("row10") \
            else "affinity_kernel"
        out[name] = _device_ms(torch, fn, tag, reps)
        if bound is not None:
            out[f"{name} bound"] = bound
            out[f"{name} bound_by"] = by
        out[f"{name} digest"] = _digest(torch, fn())
    return out


def run_check(tree: str) -> None:
    """Each case: the step kernel and the resident kernel (20 steps)
    against their plain versions, the resident launch against 20 step
    launches, and two resident launches, all bit for bit; prints the
    compiler's resource report first."""
    import torch

    build, pk, offsets = _setup(tree)
    for source in ("par_diffuse_valid", "par_diffuse", "par_pad_clamp",
                   "par_affinity"):
        with open(build.library_path(source) + ".log") as f:
            for line in f:
                if any(k in line for k in ("entry function", "registers",
                                           "spill")):
                    print(f"build[{source}]: {line.strip()}", flush=True)
    for seed, (name, (b, c, h, w, ext)) in enumerate(CASES.items()):
        mp, aff, valid, _, _ = _inputs(torch, pk, offsets, b, c, h, w, ext,
                                       seed)
        step = pk.par_diffuse_padded_valid(mp, aff, valid, offsets, h, w)
        ref = pk.par_diffuse_padded_valid_reference(mp, aff, valid, offsets,
                                                    h, w)
        res = pk.par_diffuse_valid_resident(mp, aff, valid, offsets, h, w,
                                            ITERS)
        again = pk.par_diffuse_valid_resident(mp, aff, valid, offsets, h, w,
                                              ITERS)
        m = mp
        for _ in range(ITERS):
            m = pk.par_diffuse_padded_valid(m, aff, valid, offsets, h, w)
        plain = pk.par_diffuse_valid_resident_reference(mp, aff, valid,
                                                        offsets, h, w, ITERS)
        torch.cuda.synchronize()
        ok = {"step == plain": torch.equal(step, ref),
              "resident == plain": torch.equal(res, plain),
              f"resident == {ITERS} steps": torch.equal(res, m),
              "two resident launches": torch.equal(res, again)}
        print(f"{name} {tuple(mp.shape)}: {ok}", flush=True)
        if not all(ok.values()):
            raise SystemExit(f"par_ab: {name} differs")
        del mp, aff, valid, step, ref, res, again, m, plain
    from excel_tpu_torch.ops.par import _replicate_valid

    for seed, (name, (dtype, dil, b, c, h, w, ext)) in enumerate(
            DIFFUSE_CASES.items()):
        masks, aff, offs = _diffuse_inputs(
            torch, pk.offsets_tensor, _replicate_valid, dtype, dil, b, c, h,
            w, ext, seed)
        got = pk.par_diffuse(masks, aff, offs)
        again = pk.par_diffuse(masks, aff, offs)
        ref = pk.par_diffuse_reference(masks, aff, offs)
        torch.cuda.synchronize()
        ok = {"kernel == plain": torch.equal(got, ref),
              "two launches": torch.equal(got, again)}
        pad = pk.staged_pad(pk._host_offsets(offs), c, masks.element_size())
        print(f"{name} K={aff.shape[1]} staged pad {pad}: {ok}", flush=True)
        if not all(ok.values()):
            raise SystemExit(f"par_ab: {name} differs")
        del masks, aff, got, again, ref
    chip_smoke = _chip_smoke()
    for k in (8, 16, 24, 32, 40, 48, 56, 64):
        print(f"affinity K={k} a pixel (SASS): "
              f"{chip_smoke.affinity_sass_counts(k)}", flush=True)
    for name, (fn, plain, (bound, by)) in _par_input_cases(torch, pk,
                                                           1).items():
        got, again, ref = fn(), fn(), plain()
        torch.cuda.synchronize()
        if name.startswith("row10"):
            ok = {"kernel == plain": torch.equal(got, ref)}
        else:
            ok = {"within one bf16 ulp of plain":
                  chip_smoke.bf16_within_ulp(got, ref)}
        ok["two launches"] = torch.equal(got, again)
        print(f"{name}: {ok}, {int((got != ref).sum())} of {got.numel()} "
              f"differ from plain, bound_ms {bound:.4f} ({by}), digest "
              f"{_digest(torch, got)}", flush=True)
        if not all(ok.values()):
            raise SystemExit(f"par_ab: {name} differs")
        del got, again, ref
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
    print(f"| case | {other} ms | {tree} ms | ratio | bound ms |")
    print("| --- | --- | --- | --- | --- |")
    for name in runs[tree][0]:
        if name.endswith((" bound", " bound_by", " digest")):
            continue
        a = min(r[name] for r in runs[other])
        c = min(r[name] for r in runs[tree])
        bound = runs[tree][0].get(name + " bound")
        by = runs[tree][0].get(name + " bound_by")
        print(f"| {name} | {a:.4f} | {c:.4f} | {a / c:.2f} | "
              + ("-" if bound is None else f"{bound:.4f}")
              + ("" if by is None else f" ({by})") + " |", flush=True)
    print(json.dumps({"card": smi, "runs": runs}), flush=True)
    differ = []
    for name in runs[tree][0]:
        if name.endswith(" digest"):
            a, c = ({r[name] for r in runs[t]} for t in (other, tree))
            print(f"{name}: {other} {sorted(a)} {tree} {sorted(c)}",
                  flush=True)
            if len(a | c) != 1:
                differ.append(name)
    if differ:
        raise SystemExit(f"par_ab: outputs differ between the trees: "
                         f"{differ}")


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
        print("par_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.check:
        run_check(tree)
        return 0
    times = run_times(tree, args.reps)
    if args.json:
        print(json.dumps(times))
    else:
        for name, v in times.items():
            print(f"{name}: {v}" if isinstance(v, str) else
                  f"{name}: {v:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
