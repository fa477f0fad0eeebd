#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (excel_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
1. environment: torch/CUDA versions, and the card's name and power limit as
   `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them;
2. build: every CUDA kernel of the port, compiled from excel_tpu_torch/csrc;
3. kernels: each kernel against its plain PyTorch version on the card at the
   main paths' shapes (plus the fp32 surgery kernel at N=901, and the
   surgery kernel with ex at the calibrated train pass's B=4), with the
   stated tolerances; CUDA-event median times of kernel, plain version and,
   where one PyTorch call computes the same function, that call. The fp32
   preset's kernels, then the fast preset's: the bf16 attention entry
   points, pad-clamp, affinity, the fused-valid step and the resident
   diffusion (and 20 step launches against one resident launch); then the
   full-extent padded steps of training's pseudo-labels (Pallas rows 8 and
   6) against row 5's and row 7's kernels at [4, 5 | 9, 320, 320] (and one
   resident launch against row 7's 20 chained steps), and the fast train
   step's pad-clamp, affinity and resident diffusion at its shapes (the
   resident launch also against 20 step launches; `F.pad` timed as
   pad-clamp's library call there; the affinity's bound from the
   instructions of its SASS); the attention kernels
   without weights and without ex at the MSC scales' token counts (197,
   577, 901 at 2 x 4 images; plain attention there and at 401 with
   `scaled_dot_product_attention` timed beside it), and every attention
   case again for two launches bit for bit and mode acc == mode out + the
   accumulator bit for bit; every mode of both
   attention kernels, surgery with and without ex, at ragged and tiny token
   counts (1, 15, 17, 63, 65) with D = 64 and 32; row 5's kernel at
   the mean-field CRF's shapes (72 offsets up to 55 px; [4, 21, 384, 512],
   [2, 81, 480, 640], [16, 4, 384, 512]) through its fp32 and its bf16
   entry point, both bit for bit;
4. the eval slices: `run_lam_eval` (training-free LAM eval at full
   ViT-B/16 width, seeded random weights) over synthetic VOC-sized samples
   in `voc_config()` (fp32) and `fast(voc_config())` (bf16 encoder with its
   matmul weights cast once, bf16 PAR), every kernel's launch count over
   each run checked against the number of batches; a device-time profile
   of one batch of each; one batch of 2 of each through `lam_eval_step` on
   the card and on the CPU (plain versions), labels compared over the
   valid pixels; then the same sweep with its on-device CRF branch,
   `run_lam_eval(crf_tpu=True)`: the batch's launches plus 10 of row 5's
   kernel at 72 offsets (fp32 entry point; bf16 under the fast preset);
5. the MSC slice, for each preset: `run_msc_seg_eval` (MSC+flip
   segmentation eval, seeded random CLIP and head) on 8 synthetic samples,
   batch 4, scales (1.0, 0.7, 1.2, 1.5) x 320 px, without and with the
   on-device CRF, launches per batch checked by the Pallas row the JAX
   package would route them to (14 row 2, 14 row 1, 15 row 3, 5 row 4, and
   10 of row 5 with the CRF); one batch's step profiled, the host's
   preparation of a batch timed, the CRF's build against its message
   passes; one batch of 2 with the CRF on the card and on the CPU: fused
   logits, predictions, and the CPU's CRF + argmax on the card's logits;
6. the training slice, for each preset: the LVC head's training steps at
   B=4, crop 320 through the three phases (pre-calibration, calibrated,
   calibrated + seg affinity), each step's launch counts checked, the head
   moved and CLIP unchanged, median step times and a profiled step; one
   calibrated step's forward and backward at B=2 on the card and on the
   CPU (pseudo-labels, losses, head gradients; the card's pseudo-labels
   also against the CPU's on the card's own LAMs and attention) and
   `denormalize_images` on all byte values; then in-training validation (`run_validation`) and the
   trained LAM sweep (`run_lam_eval(mode="trained")`) with the trained head;
7. the text side and the eval CLIs: the VOC text bank (45 prompts, TSE
   over the shipped attribute bank) at ViT-B/16's text widths on the card
   against the CPU in both presets, with its build time; the weights saved
   with `save_params_npz` (and a head with `save_head_npz`), then the CLIs'
   `main(argv)` on an 8-image synthetic tree: `infer_lam --training-free
   --crf-tpu` in both presets, `infer_lam --head` and `infer_seg --head
   --save-preds` in the fast preset, `rescore` of those predictions (equal
   to infer_seg's scores); each CLI's kernels launched, img/s of each.

The JSON kernel table has one line per Pallas function (rows 1-4 for each
dtype; row 5 for PAR's step and for the CRF's message pass in fp32 and
bf16); `launches` counts the launches of the route that stands for that
function (the attention wrappers' attribution by mode and token count, the
fp32 and bf16 steps on valid or full extents, the step at the CRF's 72
offsets) over all main-path runs: the eval slices with their CRF sweeps,
the MSC slices, the train steps, the two trained sweeps and the CLIs.
The line before the last is the JSON kernel table; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": <name>, "count": N}}.
It imports neither jax nor excel_tpu. It exits non-zero without a CUDA
device.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the
# tensor cores, bf16 on the tensor cores, and HBM3 bandwidth. The fp32
# kernels and the PAR kernels (bf16 products formed and summed in fp32
# units) are held to the fp32 rate; the bf16 attention entry points to the
# bf16 tensor-core rate, the least time a bf16 attention could take.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# main-path shapes: voc_config() encoder at batch 16 and its PAR canvas
B, HEADS, N_TOK, HEAD_DIM = 16, 12, 401, 64
PAR_C, PAR_H, PAR_W = 4, 384, 512
DILATIONS = (1, 2, 4, 8, 12, 24)
PAR_PAD, PAR_ITERS = 24, 20
# tolerances against the plain versions on the card: fp32 sums taken in
# another order (a wrong tile or a dropped key chunk is off by > 1e-3)
TOL_ATTN = 1e-4
TOL_PAR_STEP = 0.0      # same arithmetic, same order: bit for bit
TOL_PAR_CHAIN = 0.0
# bf16 outputs (the bf16 attention contexts, the PAR affinity) against
# their plain versions: at most one bf16 ulp of the reference's own size,
# |got - ref| <= 2^-7 |ref| + TINY. The contexts round fp32 sums taken in
# another order; the affinity keeps the plain version's order of rounding,
# but expf and PyTorch's division by a Python scalar (a product with the
# reciprocal on the card) differ by an fp32 ulp. Either may land on the
# neighbouring bf16 value, no further. TINY, the smallest normal fp32, is
# for subnormal values (far offsets' affinities), whose bf16 ulp is coarser
# than 2^-7 of them. An affinity without its position term (w2 * pos_w, up
# to 7.6e-4 against affinities of about 0.02) is off by far more.
TOL_BF16_REL = 2.0 ** -7
TINY = torch.finfo(torch.float32).tiny
# the bf16 attention contexts get two more terms. (1) An absolute one, 2^-20
# max|v|: the tensor cores sum the 16 products of an instruction without
# rounding each partial sum to fp32, so where a context cancels to nearly 0
# (|ref| < 1e-5 among values of 0.05) the two sums differ by a few fp32 ulps
# of the terms (p |v| <= max|v|), more than a bf16 ulp of the tiny result.
# (2) `context_rounding_allowance`: the normalised p is rounded to bf16
# before P V, and the kernel's fp32 p (2^x from the MUFU, one reciprocal a
# row) differs from torch.softmax's by a few fp32 ulps, so a p that lies
# within 2^-20 of its size from the midpoint of two bf16 values may round to
# the other one; the allowance is one bf16 ulp of exactly those p times
# |v| of their keys, and 0 elsewhere (about 1 p in 2,000 qualifies).
CTX_ABS_OF_VMAX = 2.0 ** -20
# pad-clamp, fused-valid step and resident diffusion: bit for bit against
# their plain versions, and 20 step launches against one resident launch
TOL_PAR_BF16 = 0.0
# share of valid pixels whose labels the card and the CPU must agree on:
# every run so far read 1.0; the 0.1% margin (the CPU slice test's bound)
# is for SVC's uint8 truncation, which can flip a box on a 1-ulp
# difference upstream
MIN_LABEL_AGREEMENT = 0.999
# the same for the fast preset: bf16 GEMMs on the card (cuBLAS) and on the
# CPU sum in other orders before rounding to bf16, and the LAMs' min-max
# normalisation and SVC's uint8 truncation can carry such an ulp into a
# label. The first run read 0.999984 (6 of 370,500 pixels); the CPU tests
# see 0.7% of labels move between the JAX package's bf16 eval and the
# port's, where XLA's fusions round differently too. Bound: 99.5%
MIN_FAST_LABEL_AGREEMENT = 0.995

# the training slice: TrainConfig.batch_size crops of voc_config()'s 320 px,
# the phase thresholds cut so that the run takes TRAIN_PHASE_STEPS steps in
# each of the three phases (the first of each untimed: allocations)
TRAIN_B, TRAIN_CROP, TRAIN_PHASE_STEPS = 4, 320, 4
# rows 6 and 8 against row 7's and row 5's kernels: masks of 5 channels
# (VOC's 4-slot bucket + bg) and 9 (COCO's 8 slots)
PADDED_CHANNELS = (5, 9)
# row 8 (fp32) against row 5's kernel: the same fp32 sums in the same
# order; the stated bound over 20 chained steps (a wrong offset or chunk is
# off by > 1e-3)
TOL_ROW8 = 1e-5
# card against CPU on one calibrated train step at B=2: the losses (fp32
# sums over 2 x 320 x 320 pixels in other orders, plus the pixels whose
# pseudo-label moves) and the head's gradient (relative to its norm)
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_RTOL = 1e-2
# the card's pseudo-labels against the CPU's pseudo_labels on the card's
# own LAMs, attention and attn_pred, any number of classes: only the
# refinement's fp32 sums differ in order
MIN_SAME_INPUT_AGREEMENT = 0.999


# the final evaluation: MSC+flip segmentation eval at scales x 320 px (320,
# 224, 384, 480 px: 401, 197, 577, 901 tokens) on batches of 4, and the
# on-device mean-field CRF, whose message pass is row 5's kernel at 72
# offsets (pad 55) over the canvas: [4, 21, 384, 512] for a VOC MSC batch,
# [2, 81, 480, 640] the COCO-sized case, [16, 4, 384, 512] the LAM sweep's
# batch in its 3-slot bucket
MSC_SCALES = (1.0, 0.7, 1.2, 1.5)
MSC_B, MSC_SAMPLES = 4, 8
CRF_SHAPES = ((4, 21, 384, 512), (2, 81, 480, 640), (16, 4, 384, 512))
CRF_ITERS = 10
# launches per MSC batch by Pallas row: 7 plain and 5 surgery launches a
# forward; scales 1.0 and 0.7 (N <= 512) take row 2 and scales 1.2 and 1.5
# row 1; scales 1.0, 0.7 and 1.2 (N <= 640) row 3 and scale 1.5 row 4
MSC_ROW_LAUNCHES = {"_plain_kernel_rows_hb": 14, "_plain_kernel": 14,
                    "_kernel": 15, "_kernel_rows": 5}
# card against CPU on one MSC batch: the fused logits within this share of
# their range (fp32 sums in other orders through 12 blocks and the head at
# four scales), and the predictions' agreement
MSC_LOGITS_RTOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """CUDA-event median of `reps` calls after one warm-up call."""
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


def median_wall_ms(step, reps: int = 3) -> float:
    """Host-clock median of `reps` synchronised calls after one warm-up."""
    walls = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls[1:])


def bound_ms(flops: float, nbytes: float,
             peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sm_clock_hz() -> float:
    """The SM clock the card reports as its maximum (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    return float(out) * 1e6


def diffuse_bound_ms(b: int, c: int, h: int, w: int, k: int,
                     elem_bytes: int) -> tuple[float, str]:
    """Bound of one `par_diffuse` step (rows 5 and 8), as tools/par_ab.py
    states it: the affinities and the masks in and out over the memory
    rate, or the operations, 64 products an SM and clock (at the SM clock
    the card reports): fp32 takes one FMUL and one FADD a product (never
    contracted into an FMA) on 128 fp32 lanes, bf16 one bf16 -> fp32
    placement a product on the 64-lane integer pipe (its fp32 add runs
    beside it)."""
    nbytes = (b * k * h * w + 2 * b * c * h * w) * elem_bytes
    rate = torch.cuda.get_device_properties(0).multi_processor_count * 64 \
        * sm_clock_hz()
    return max((nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"),
               (b * c * h * w * k / rate * 1e3, "operations"))


_SASS_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_BRA = re.compile(r"\bBRA\b[.\w]*\s+(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)")


def affinity_sass_counts(k: int) -> dict:
    """Instructions a pixel of the affinity kernel (Pallas row 11) executes at
    K offsets, counted in the SASS of its K instantiations (`build.sass`;
    the one for the paths' pads): its loop over a lane's rows (the
    function's longest backward branch) handles two pixels, and the loop
    inside it one pixel at a time, so a pixel counts half the row loop's
    body outside the inner loop and the inner loop's body. fp32: FADD, FMUL
    and FFMA (the FMA pipe, 128 lanes an SM); mufu: MUFU.* (16 lanes an
    SM); lds: shared loads; all: every instruction. The bodies hold no fp32
    or MUFU instruction off their common path: the rare pixels (a sum
    outside [2^-100, inf)), IEEE divisions and square roots are
    subroutines outside them."""
    from excel_tpu_torch import build

    tag = f"affinity_kernelILi{k}ELi9216E"
    text = next(f for f in build.sass("par_affinity").split("Function : ")
                if tag in f.split("\n", 1)[0])
    ins = [(int(a, 16), re.sub(r"^@!?U?P\w+\s+", "", t).split()[0])
           for a, t in _SASS_INS.findall(text)]
    loops = sorted(((int(m.group(1), 16), a) for a, t in
                    _SASS_INS.findall(text) for a in [int(a, 16)]
                    for m in [_SASS_BRA.search(t)]
                    if m and int(m.group(1), 16) < a),
                   key=lambda ht: ht[0] - ht[1])
    head, tail = loops[0]
    inner = [(h, t) for h, t in loops[1:] if head <= h and t <= tail][:1]
    ih, it = inner[0] if inner else (tail + 1, tail)

    def count(pred):
        outer = sum(pred(o) for a, o in ins
                    if head <= a <= tail and not ih <= a <= it)
        return outer / 2 + sum(pred(o) for a, o in ins if ih <= a <= it) \
            if inner else outer / 2

    fp32 = count(lambda o: o.split(".")[0] in ("FADD", "FMUL", "FFMA"))
    return {"fp32": fp32, "mufu": count(lambda o: o.startswith("MUFU")),
            "lds": count(lambda o: o.startswith("LDS")),
            "all": count(lambda o: True)}


def affinity_bound_ms(pixels: int, nbytes: int, k: int):
    """Bound of one affinity launch over `pixels` output pixels at K offsets
    moving `nbytes` (the padded image read once, the bf16 stack written
    once): the largest of the bytes over the memory rate, the fp32
    instructions a pixel on 128 lanes an SM and the MUFU instructions on 16
    (at the SM clock the card reports), both counted in the kernel's SASS.
    Returns (ms, "bytes" or "operations", the winning term, the counts)."""
    counts = affinity_sass_counts(k)
    rate = torch.cuda.get_device_properties(0).multi_processor_count \
        * sm_clock_hz()
    terms = [(nbytes / PEAK_BYTES_PER_S * 1e3, "bytes", "bytes"),
             (pixels * counts["fp32"] / (rate * 128) * 1e3, "operations",
              "fp32"),
             (pixels * counts["mufu"] / (rate * 16) * 1e3, "operations",
              "mufu")]
    ms, by, term = max(terms)
    return ms, by, term, counts


def max_err(a, b) -> float:
    if a is None and b is None:
        return 0.0
    return float((a - b).abs().max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(smi)
    # no TF32; bf16 GEMMs accumulate in fp32 all the way (JAX's
    # preferred_element_type=float32), as the CLIs set it
    from excel_tpu_torch.cli.common import exact_matmuls
    exact_matmuls()
    return smi


def phase_build() -> None:
    from excel_tpu_torch import build

    t0 = time.perf_counter()
    seconds = build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
        + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    for name in build.ENTRY_POINTS:
        with open(build.library_path(name) + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"build[{name}]: {line.strip()}")


def _qkv(gen, b, n, dtype, heads=HEADS, d=HEAD_DIM):
    shape = (b, heads, n, d)
    return [torch.randn(shape, device="cuda", generator=gen).to(dtype)
            for _ in range(3)]


def bf16_within_ulp(got, ref) -> bool:
    """|got - ref| <= 2^-7 |ref| + the smallest normal fp32 everywhere: at
    most one bf16 ulp of the reference's own size."""
    g, r = got.float(), ref.float()
    return bool(((g - r).abs() <= TOL_BF16_REL * r.abs() + TINY).all())


def check_outputs(got, ref, what: str, ctx_slack=None) -> float:
    """Max abs error of a kernel's outputs against its plain version's; fp32
    outputs within TOL_ATTN, bf16 ones within one bf16 ulp of their size
    plus `ctx_slack` (the attention contexts' two extra terms, see
    CTX_ABS_OF_VMAX)."""
    err = 0.0
    for g, r in zip(got, ref):
        if (g is None) != (r is None):
            raise AssertionError(f"{what}: outputs differ in presence")
        if g is None:
            continue
        gf, rf = g.float(), r.float()
        e = max_err(gf, rf)
        err = max(err, e)
        if g.dtype == torch.bfloat16:
            lim = TOL_BF16_REL * rf.abs() + TINY
            if ctx_slack is not None:
                lim = lim + ctx_slack
            ok = bool(((gf - rf).abs() <= lim).all())
        else:
            ok = e <= TOL_ATTN
        if not ok or not bool(torch.isfinite(gf).all()):
            raise AssertionError(f"{what}: {g.dtype} output off by {e}")
    return err


def check_attention_case(fused, plain, q, k, v, acc0, mode, kw,
                         what: str) -> float:
    """One attention case on the card: the kernel against its plain
    version, two launches bit for bit, and mode acc == mode out + the
    accumulator bit for bit. Returns the max abs error."""
    from excel_tpu_torch.models.attention_kernels import (
        context_rounding_allowance)

    def acc():
        return acc0.clone() if mode == "acc" else None

    got = fused(q, k, v, acc=acc(), **kw)
    again = fused(q, k, v, acc=acc(), **kw)
    slack = (context_rounding_allowance(q, k, v)
             + CTX_ABS_OF_VMAX * float(v.float().abs().max()))
    err = check_outputs(got, plain(q, k, v, acc=acc(), **kw), what, slack)
    for g, a in zip(got, again):
        if g is not None and not torch.equal(g, a):
            raise AssertionError(f"{what}: two launches differ")
    if mode == "acc":
        flag = "need_weights" if "need_weights" in kw else "need_attn"
        out = fused(q, k, v, acc=None, **{**kw, flag: True})
        # output 1 is the accumulated one (weights, attn_sum)
        for i, (g, o) in enumerate(zip(got, out)):
            if not torch.equal(g, o + acc0 if i == 1 else o):
                raise AssertionError(f"{what}: acc != out + accumulator")
    return err


# the case each attention row's record is timed at, (mode, N, B, with ex):
# the LAM eval batch's for rows 1-3 (block 6, blocks 0-5, blocks 7-11), the
# MSC batch's largest scale for row 4 (no weights, no ex, 2 x 4 images)
MSC_B2 = 8
TIMED_CASE = {"plain_attention": ("out", 401, 16, False),
              "plain_attention_rows_hb": ("none", 401, 16, False),
              "surgery_attention": ("acc", 401, 16, False),
              "surgery_attention_rows": ("none", 901, MSC_B2, False)}
# token counts of the MSC scales 0.7, 1.2 and 1.5 of 320 px (1.0: N_TOK)
MSC_TOKENS = (197, 577, 901)
EDGE_TOKENS = (1, 15, 17, 63, 65)


def check_attention(gen, dtype) -> dict:
    """The plain and surgery attention kernels against their plain versions
    at the main paths' shapes in `dtype` (float32 also runs the surgery
    kernel at N=901 with ex; both run the train step's modes at its B=4,
    the surgery kernel with ex among them, and the MSC batch's: no weights,
    no ex, N = 197, 577 and 901 at 2 x 4 images), then every mode at the
    EDGE_TOKENS with D = 64 and 32. Returns {kernel name: record} for the
    JSON table, one per Pallas row, timed at TIMED_CASE."""
    from excel_tpu_torch.models.attention_kernels import (
        fused_plain_attention, fused_surgery_attention,
        plain_attention_reference, surgery_attention_reference)

    bf16 = dtype == torch.bfloat16
    suffix = "_bf16" if bf16 else ""
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS
    el = torch.empty((), dtype=dtype).element_size()
    tol = (f"fp32 <= {TOL_ATTN}, bf16 <= 2^-7 |ref| + 2^-20 max|v| + the "
           f"rounding allowance of p" if bf16 else f"<= {TOL_ATTN}")
    records = {}
    # (kernel, mode, N, B, with ex): plain none (blocks 0-5), out (block 6)
    # and acc; surgery acc (blocks 7-11), out and none
    cases = [("plain", m, N_TOK, B, False) for m in ("none", "out", "acc")]
    cases += [("surgery", m, N_TOK, B, False) for m in ("acc", "out", "none")]
    if not bf16:
        cases += [("surgery", "out", 901, 8, True),
                  ("surgery", "none", 901, 8, True)]
    # the train step at its batch: the pre-calibration pass (plain none and
    # out, surgery acc), the calibrated step's stack pass (surgery out) and
    # its second pass (plain none, surgery with ex and no weights; its ex:
    # the compute type's values, carried in fp32)
    cases += [("plain", m, N_TOK, TRAIN_B, False) for m in ("none", "out")]
    cases += [("surgery", m, N_TOK, TRAIN_B, False) for m in ("acc", "out")]
    cases += [("surgery", "none", N_TOK, TRAIN_B, True)]
    # the MSC batch: attn_mode "none" without ex, scale 1.0 unflipped (B=4;
    # the plain kernel's case is the train step's above) and the other
    # scales' token counts at 2 x 4 images
    cases += [("surgery", "none", N_TOK, TRAIN_B, False)]
    cases += [(kind, "none", n, MSC_B2, False) for n in MSC_TOKENS
              for kind in ("plain", "surgery")]
    for kind, mode, n, b, with_ex in cases:
        q, k, v = _qkv(gen, b, n, dtype)
        acc0 = torch.rand((b, n, n), device="cuda", generator=gen)
        nn = b * n * n * 4
        nbytes = (4 * b * HEADS * n * HEAD_DIM * el
                  + {"none": 0, "out": nn, "acc": 2 * nn}[mode])
        if kind == "plain":
            kw = dict(need_weights=mode != "none")
            fused, plain = fused_plain_attention, plain_attention_reference
            flops = 2 * 2 * n * n * HEAD_DIM * HEADS * b
        else:
            ex = (torch.rand((b, n, n), device="cuda", generator=gen) / n
                  if with_ex else None)
            if ex is not None:
                ex = ex.to(dtype).float()
            kw = dict(ex_attn=ex, need_attn=mode != "none")
            fused, plain = fused_surgery_attention, surgery_attention_reference
            flops = 5 * 2 * n * n * HEAD_DIM * HEADS * b
            nbytes += nn + (nn if with_ex else 0)   # shared out, ex in
        # the Pallas row the JAX package routes the case to: row 2 (plain,
        # no weights, N <= 512) or row 1; row 3 or (N > 640) row 4
        row = ("_rows_hb" if mode == "none" and n <= 512 else "") \
            if kind == "plain" else ("_rows" if n > 640 else "")
        name = f"{kind}_attention{row}{suffix}"
        what = f"{name} mode={mode} B={b} H={HEADS} N={n} D={HEAD_DIM}"
        err = check_attention_case(fused, plain, q, k, v, acc0, mode, kw,
                                   what)
        acc = acc0.clone()
        kernel_ms = time_ms(lambda: fused(
            q, k, v, acc=acc if mode == "acc" else None, **kw), 10)
        plain_ms = time_ms(lambda: plain(
            q, k, v, acc=acc if mode == "acc" else None, **kw),
            5 if kind == "plain" else 3)
        library = (time_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                           10) if (kind, mode) == ("plain", "none") else None)
        bnd, by = bound_ms(flops, nbytes, peak)
        log(f"kernel {what} ex={with_ex}: max_abs_err={err:.3g} ({tol}) "
            f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library} bound_ms={bnd:.4f} ({by})")
        rec = records.setdefault(name, dict(max_abs_err=0.0))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if (mode, n, b, with_ex) == TIMED_CASE[name.removesuffix(suffix)]:
            rec.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=library,
                       bound_ms=bnd, bound_by=by)
    # ragged and tiny token counts (one key, tails of 1 and 15 rows on
    # either side of the 16-row fragments and 64-row tiles) and D=32, every
    # mode, surgery with and without ex; not timed
    worst = 0.0
    for n in EDGE_TOKENS:
        for d in (64, 32):
            q, k, v = _qkv(gen, 2, n, dtype, heads=3, d=d)
            acc0 = torch.rand((2, n, n), device="cuda", generator=gen)
            ex = (torch.rand((2, n, n), device="cuda", generator=gen)
                  / n).to(dtype).float()
            for mode in ("none", "out", "acc"):
                what = f"attention{suffix} edge mode={mode} N={n} D={d}"
                worst = max(worst, check_attention_case(
                    fused_plain_attention, plain_attention_reference, q, k, v,
                    acc0, mode, dict(need_weights=mode != "none"),
                    "plain " + what))
                for e in (None, ex):
                    worst = max(worst, check_attention_case(
                        fused_surgery_attention, surgery_attention_reference,
                        q, k, v, acc0, mode,
                        dict(ex_attn=e, need_attn=mode != "none"),
                        "surgery " + what))
    log(f"kernel attention{suffix} edge cases N={EDGE_TOKENS} D=64,32 B=2 H=3 "
        f"every mode, surgery with and without ex: max_abs_err={worst:.3g} "
        f"({tol}); two launches bit for bit; acc == out + accumulator")
    return records


def phase_kernels() -> dict:
    """Each fp32 kernel against its plain version at the main path's shapes.
    Returns {kernel name: record} for the JSON table."""
    from excel_tpu_torch.ops.par import _offsets, _replicate_valid
    from excel_tpu_torch.ops.par_kernels import (
        offsets_tensor, par_diffuse, par_diffuse_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    records = check_attention(gen, torch.float32)
    f32 = 4

    # -- PAR diffusion: one step, and 20 chained steps with the clamp -----
    k_off = 8 * len(DILATIONS)
    masks = torch.rand((B, PAR_C, PAR_H, PAR_W), device="cuda", generator=gen)
    aff = torch.rand((B, k_off, PAR_H, PAR_W), device="cuda", generator=gen)
    aff = (aff / aff.sum(dim=1, keepdim=True)).contiguous()
    offsets = offsets_tensor(_offsets(DILATIONS), "cuda")
    valid = torch.tensor([[375, 500], [333, 500], [384, 512], [300, 450]]
                         * (B // 4), device="cuda", dtype=torch.int32)
    masks = _replicate_valid(masks, valid)
    err_step = max_err(par_diffuse(masks, aff, offsets),
                       par_diffuse_reference(masks, aff, offsets))
    if not err_step <= TOL_PAR_STEP:
        raise AssertionError(f"par_diffuse step: max err {err_step}")
    m_k, m_r = masks, masks
    for _ in range(20):
        m_k = _replicate_valid(par_diffuse(m_k, aff, offsets), valid)
        m_r = _replicate_valid(par_diffuse_reference(m_r, aff, offsets),
                               valid)
    err_chain = max_err(m_k, m_r)
    if not err_chain <= TOL_PAR_CHAIN:
        raise AssertionError(f"par_diffuse 20 steps: max err {err_chain}")
    kernel = time_ms(lambda: par_diffuse(masks, aff, offsets), 20)
    plain = time_ms(lambda: par_diffuse_reference(masks, aff, offsets), 5)
    bnd, by = diffuse_bound_ms(B, PAR_C, PAR_H, PAR_W, k_off, f32)
    log(f"kernel par_diffuse B={B} C={PAR_C} K={k_off} {PAR_H}x{PAR_W}: "
        f"max_abs_err step={err_step:.3g} chain20={err_chain:.3g} "
        f"(tol {TOL_PAR_STEP}) kernel_ms={kernel:.4f} plain_ms={plain:.4f} "
        f"library_ms=None bound_ms={bnd:.4f} ({by})")
    records["par_diffuse"] = dict(
        ms=kernel, plain_ms=plain, library_ms=None, bound_ms=bnd,
        bound_by=by, max_abs_err=max(err_step, err_chain))
    return records


def phase_kernels_fast() -> dict:
    """The fast preset's kernels against their plain versions at the fast
    main path's shapes. Returns {kernel name: record}."""
    from excel_tpu_torch.ops import par_kernels as pk
    from excel_tpu_torch.ops.par import _offsets, _pos_weight

    gen = torch.Generator(device="cuda").manual_seed(1)
    records = check_attention(gen, torch.bfloat16)
    bf16, f32 = 2, 4

    # -- PAR inputs at the fast path's shapes -----------------------------
    offsets = _offsets(DILATIONS)      # (dy, dx) pairs, as the JAX API
    k_off = len(offsets)
    pos_w = [float(p) for p in _pos_weight(DILATIONS)]
    valid = torch.tensor([[375, 500], [333, 500], [384, 512], [300, 450]]
                         * (B // 4), device="cuda", dtype=torch.int32)
    valid_px = int((valid[:, 0] * valid[:, 1]).sum())
    images = torch.randn((B, 3, PAR_H, PAR_W), device="cuda", generator=gen)
    masks = torch.rand((B, PAR_C, PAR_H, PAR_W), device="cuda",
                       generator=gen).bfloat16()

    # -- pad-clamp: the images (fp32) and the masks (bf16), per batch ------
    rec = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0)
    for x in (images, masks):
        got = pk.pad_replicate_valid(x, valid, PAR_PAD)
        err = max_err(got.float(),
                      pk.pad_replicate_valid_reference(x, valid,
                                                       PAR_PAD).float())
        if not err <= TOL_PAR_BF16:
            raise AssertionError(f"pad_replicate_valid {x.dtype}: {err}")
        kernel = time_ms(lambda: pk.pad_replicate_valid(x, valid, PAR_PAD),
                         20)
        plain = time_ms(lambda: pk.pad_replicate_valid_reference(
            x, valid, PAR_PAD), 5)
        bnd, by = bound_ms(0, x.numel() * x.element_size()
                           + got.numel() * got.element_size())
        log(f"kernel pad_replicate_valid {tuple(x.shape)} {x.dtype} -> "
            f"{tuple(got.shape)}: max_abs_err={err:.3g} (tol "
            f"{TOL_PAR_BF16}) kernel_ms={kernel:.4f} plain_ms={plain:.4f} "
            f"library_ms=None bound_ms={bnd:.4f} ({by})")
        rec["ms"] += kernel
        rec["plain_ms"] += plain
        rec["bound_ms"] += bnd
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
    # library_ms: F.pad at the train step's full extents
    # (check_fast_train_par); at these valid extents no one call computes it
    records["pad_replicate_valid"] = dict(rec, bound_by="bytes",
                                          library_ms=None)

    # -- affinity: padded fp32 image -> bf16 [B, 48, 384, 512] ------------
    ip = pk.pad_replicate_valid(images, valid, PAR_PAD)
    aff = pk.par_affinity(ip, offsets, pos_w, PAR_H, PAR_W)
    aff_ref = pk.par_affinity_reference(ip, offsets, pos_w, PAR_H, PAR_W)
    err = max_err(aff.float(), aff_ref.float())
    if not bf16_within_ulp(aff, aff_ref):
        raise AssertionError(f"par_affinity: beyond one bf16 ulp (max abs "
                             f"err {err})")
    kernel = time_ms(lambda: pk.par_affinity(ip, offsets, pos_w, PAR_H,
                                             PAR_W), 10)
    plain = time_ms(lambda: pk.par_affinity_reference(
        ip, offsets, pos_w, PAR_H, PAR_W), 3)
    bnd, by, term, counts = affinity_bound_ms(
        B * PAR_H * PAR_W, ip.numel() * f32 + aff.numel() * bf16, k_off)
    log(f"kernel par_affinity {tuple(ip.shape)} -> {tuple(aff.shape)} "
        f"bf16: max_abs_err={err:.3g} (tol 2^-7 |ref| + 2^-126) kernel_ms="
        f"{kernel:.4f} plain_ms={plain:.4f} library_ms=None bound_ms="
        f"{bnd:.4f} ({by}: {term}; a pixel's SASS {counts})")
    records["par_affinity"] = dict(ms=kernel, plain_ms=plain, library_ms=None,
                                   bound_ms=bnd, bound_by=by, max_abs_err=err)

    # -- fused-valid step (row 7) and resident diffusion (row 9) ----------
    mp = pk.pad_replicate_valid(masks, valid, PAR_PAD)
    step = pk.par_diffuse_padded_valid(mp, aff, valid, offsets, PAR_H, PAR_W)
    err_step = max_err(step.float(), pk.par_diffuse_padded_valid_reference(
        mp, aff, valid, offsets, PAR_H, PAR_W).float())
    if not err_step <= TOL_PAR_BF16:
        raise AssertionError(f"par_diffuse_padded_valid: max err {err_step}")
    kernel = time_ms(lambda: pk.par_diffuse_padded_valid(
        mp, aff, valid, offsets, PAR_H, PAR_W), 20)
    plain = time_ms(lambda: pk.par_diffuse_padded_valid_reference(
        mp, aff, valid, offsets, PAR_H, PAR_W), 3)
    # the products and sums of the valid pixels (the rest are copies); the
    # bytes a step must move: the valid pixels' affinities (a step reads no
    # other), the canvas in and the canvas out
    step_flops = 2 * k_off * PAR_C * valid_px
    step_bytes = valid_px * k_off * bf16 + 2 * mp.numel() * bf16
    bnd, by = bound_ms(step_flops, step_bytes)
    log(f"kernel par_diffuse_padded_valid {tuple(mp.shape)} K={k_off} bf16: "
        f"max_abs_err={err_step:.3g} (tol {TOL_PAR_BF16}) kernel_ms="
        f"{kernel:.4f} plain_ms={plain:.4f} library_ms=None bound_ms="
        f"{bnd:.4f} ({by})")
    records["par_diffuse_padded_valid"] = dict(
        ms=kernel, plain_ms=plain, library_ms=None, bound_ms=bnd, bound_by=by,
        max_abs_err=err_step)

    res = pk.par_diffuse_valid_resident(mp, aff, valid, offsets, PAR_H, PAR_W,
                                        PAR_ITERS)
    m = mp
    for _ in range(PAR_ITERS):
        m = pk.par_diffuse_padded_valid(m, aff, valid, offsets, PAR_H, PAR_W)
    err_steps = max_err(res.float(), m.float())
    err_res = max_err(res.float(), pk.par_diffuse_valid_resident_reference(
        mp, aff, valid, offsets, PAR_H, PAR_W, PAR_ITERS).float())
    if not (err_steps <= TOL_PAR_BF16 and err_res <= TOL_PAR_BF16):
        raise AssertionError(f"par_diffuse_valid_resident: max err against "
                             f"{PAR_ITERS} step launches {err_steps}, "
                             f"against its plain version {err_res}")
    kernel = time_ms(lambda: pk.par_diffuse_valid_resident(
        mp, aff, valid, offsets, PAR_H, PAR_W, PAR_ITERS), 10)
    steps_ms = time_ms(lambda: [pk.par_diffuse_padded_valid(
        mp, aff, valid, offsets, PAR_H, PAR_W) for _ in range(PAR_ITERS)], 5)
    plain = time_ms(lambda: pk.par_diffuse_valid_resident_reference(
        mp, aff, valid, offsets, PAR_H, PAR_W, PAR_ITERS), 2)
    # every step streams the valid pixels' affinities from device memory
    # again: the stack (302 MB, 263 MB of it valid) is six times the 50 MiB
    # L2, so no kernel can keep it between steps; each step also reads one
    # canvas and writes the other (L2 could hold at most 52 MB of a step's
    # 335 MB, so this counts up to 16% too many bytes)
    bnd, by = bound_ms(PAR_ITERS * step_flops, PAR_ITERS * step_bytes)
    log(f"kernel par_diffuse_valid_resident {tuple(mp.shape)} K={k_off} "
        f"iters={PAR_ITERS} bf16: max_abs_err vs {PAR_ITERS} step launches="
        f"{err_steps:.3g} vs plain={err_res:.3g} (tol {TOL_PAR_BF16}) "
        f"kernel_ms={kernel:.4f} step_launches_ms={steps_ms:.4f} plain_ms="
        f"{plain:.4f} library_ms=None bound_ms={bnd:.4f} ({by})")
    records["par_diffuse_valid_resident"] = dict(
        ms=kernel, plain_ms=plain, library_ms=None, bound_ms=bnd, bound_by=by,
        max_abs_err=max(err_steps, err_res))
    return records


def phase_kernels_padded() -> dict:
    """Pallas rows 8 and 6, the full-extent padded diffusion steps of the
    train step's pseudo-labels, at their shapes ([4, C, 320, 320], C = 5
    and 9, K=48, pad 24): row 5's kernel (unpadded, clamped reads) against
    plain row 8 (fp32, on the edge-padded [B, H+2P, C8, Wp] canvas), and
    row 7's kernel with full extents against plain row 6 (bf16 products,
    fp32 sums, on the [B, C, H+2P+8, Wp] canvas), one step and 20 chained.
    Returns the records of the rows at C=5, the VOC train step's."""
    from excel_tpu_torch.ops import par_kernels as pk
    from excel_tpu_torch.ops.par import _offsets

    gen = torch.Generator(device="cuda").manual_seed(2)
    offs = _offsets(DILATIONS)
    k_off = len(offs)
    offsets = pk.offsets_tensor(offs, "cuda")
    b, h, w, p = TRAIN_B, TRAIN_CROP, TRAIN_CROP, PAR_PAD
    full = torch.tensor([[h, w]] * b, device="cuda", dtype=torch.int32)
    records = {}
    for c in PADDED_CHANNELS:
        masks = torch.rand((b, c, h, w), device="cuda", generator=gen)
        aff = torch.rand((b, k_off, h, w), device="cuda", generator=gen)
        aff = (aff / aff.sum(dim=1, keepdim=True)).contiguous()

        # -- row 8: fp32, [B, H+2P, C8, Wp] ------------------------------
        def interior(canvas):
            return canvas[:, p:p + h, :c, p:p + w].permute(0, 2, 1, 3)

        mp = pk.pad_for_diffuse_hcw(masks, p)
        m_k, m_r, errs = masks, mp, []
        for _ in range(PAR_ITERS):
            m_k = pk.par_diffuse(m_k, aff, offsets)
            m_r = pk.par_diffuse_padded_hcw_reference(m_r, aff, offs, h, w)
            errs.append(max_err(m_k, interior(m_r)))
        if not max(errs) <= TOL_ROW8:
            raise AssertionError(f"row 8 C={c}: max err per step {errs}")
        kernel = time_ms(lambda: pk.par_diffuse(masks, aff, offsets), 20)
        plain = time_ms(lambda: pk.par_diffuse_padded_hcw_reference(
            mp, aff, offs, h, w), 3)
        step_flops = 2 * k_off * b * c * h * w
        bnd, by = diffuse_bound_ms(b, c, h, w, k_off, 4)
        log(f"kernel par_diffuse_padded_hcw (row 8, row 5's kernel) "
            f"B={b} C={c} K={k_off} {h}x{w} pad={p} fp32: max_abs_err "
            f"step1={errs[0]:.3g} chain{PAR_ITERS}={errs[-1]:.3g} (max "
            f"{max(errs):.3g}, tol {TOL_ROW8}) kernel_ms={kernel:.4f} "
            f"plain_ms={plain:.4f} library_ms=None bound_ms={bnd:.4f} ({by})")
        if c == PADDED_CHANNELS[0]:
            records["par_diffuse_padded_hcw"] = dict(
                ms=kernel, plain_ms=plain, library_ms=None, bound_ms=bnd,
                bound_by=by, max_abs_err=max(errs))

        # -- row 6: bf16, [B, C, H+2P+8, Wp] -----------------------------
        m16, a16 = masks.bfloat16(), aff.bfloat16()
        mp16 = pk.pad_for_diffuse(m16, p)
        m_k, m_r, errs = mp16, mp16, []
        for _ in range(PAR_ITERS):
            m_k = pk.par_diffuse_padded_valid(m_k, a16, full, offs, h, w)
            m_r = pk.par_diffuse_padded_reference(m_r, a16, offs, h, w)
            errs.append(max_err(m_k.float(), m_r.float()))
        # and one resident launch of the same 20 steps
        res = pk.par_diffuse_valid_resident(mp16, a16, full, offs, h, w,
                                            PAR_ITERS)
        errs.append(max_err(res.float(), m_k.float()))
        if not max(errs) <= TOL_PAR_BF16:
            raise AssertionError(f"row 6 C={c}: max err per step, then "
                                 f"resident vs {PAR_ITERS} steps: {errs}")
        kernel = time_ms(lambda: pk.par_diffuse_padded_valid(
            mp16, a16, full, offs, h, w), 20)
        plain = time_ms(lambda: pk.par_diffuse_padded_reference(
            mp16, a16, offs, h, w), 3)
        bnd, by = bound_ms(step_flops, a16.numel() * 2 + 2 * mp16.numel() * 2)
        log(f"kernel par_diffuse_padded (row 6, row 7's kernel at full "
            f"extents) {tuple(mp16.shape)} K={k_off} bf16: max_abs_err "
            f"step1={errs[0]:.3g} chain{PAR_ITERS}={errs[-2]:.3g} resident "
            f"vs steps={errs[-1]:.3g} (tol {TOL_PAR_BF16}) kernel_ms="
            f"{kernel:.4f} plain_ms={plain:.4f} "
            f"library_ms=None bound_ms={bnd:.4f} ({by})")
        if c == PADDED_CHANNELS[0]:
            records["par_diffuse_padded"] = dict(
                ms=kernel, plain_ms=plain, library_ms=None, bound_ms=bnd,
                bound_by=by, max_abs_err=max(errs))
    return records


def check_fast_train_par(records: dict) -> None:
    """The fast train step's PAR kernels at its shapes, chained as
    `par_refine` chains them with full extents: pad-clamp of the fp32
    images [4, 3, 320, 320] and of the bf16 masks [4, 5, 320, 320] onto the
    [., ., 376, 384] canvas (320 + 2 x 24 is no multiple of 128), the
    affinity [4, 48, 320, 320] and the resident diffusion of PAR_ITERS
    steps, each against its plain version on the same inputs: pad-clamp
    and resident bit for bit, the affinity within one bf16 ulp. Folds each
    error into the kernel's record (whose times are the eval path's), logs
    the kernel times at these shapes and the affinity's bound, and times
    pad-clamp's library call, F.pad replicate of both tensors (equal to the
    kernel's output at these full extents), into its record."""
    from excel_tpu_torch.ops import par_kernels as pk
    from excel_tpu_torch.ops.par import _offsets, _pos_weight

    gen = torch.Generator(device="cuda").manual_seed(3)
    offs = _offsets(DILATIONS)
    pos_w = [float(p) for p in _pos_weight(DILATIONS)]
    b, c, h, w, p = TRAIN_B, PADDED_CHANNELS[0], TRAIN_CROP, TRAIN_CROP, PAR_PAD
    full = torch.tensor([[h, w]] * b, device="cuda", dtype=torch.int32)
    # the denormalised crops (values in [0, 1]) and the CAM stack
    images = torch.rand((b, 3, h, w), device="cuda", generator=gen)
    masks = torch.rand((b, c, h, w), device="cuda", generator=gen).bfloat16()
    ip = pk.pad_replicate_valid(images, full, p)
    mp = pk.pad_replicate_valid(masks, full, p)
    aff = pk.par_affinity(ip, offs, pos_w, h, w)
    res = pk.par_diffuse_valid_resident(mp, aff, full, offs, h, w, PAR_ITERS)
    m = mp
    for _ in range(PAR_ITERS):
        m = pk.par_diffuse_padded_valid(m, aff, full, offs, h, w)
    err_steps = max_err(res.float(), m.float())
    aff_ref = pk.par_affinity_reference(ip, offs, pos_w, h, w)
    errs = {
        "pad_replicate_valid": max(
            max_err(ip, pk.pad_replicate_valid_reference(images, full, p)),
            max_err(mp.float(), pk.pad_replicate_valid_reference(
                masks, full, p).float())),
        "par_affinity": max_err(aff.float(), aff_ref.float()),
        "par_diffuse_valid_resident": max_err(
            res.float(), pk.par_diffuse_valid_resident_reference(
                mp, aff, full, offs, h, w, PAR_ITERS).float())}
    ms = {"pad_replicate_valid": time_ms(lambda: (
              pk.pad_replicate_valid(images, full, p),
              pk.pad_replicate_valid(masks, full, p)), 20),
          "par_affinity": time_ms(lambda: pk.par_affinity(
              ip, offs, pos_w, h, w), 20),
          "par_diffuse_valid_resident": time_ms(
              lambda: pk.par_diffuse_valid_resident(
                  mp, aff, full, offs, h, w, PAR_ITERS), 10)}
    # pad-clamp at full extents is edge padding: one F.pad (replicate) a
    # tensor computes it, slack included (timed beside the kernel, never
    # used by the port)
    hp, wp = ip.shape[2:]
    lib_pad = (p, wp - w - p, p, hp - h - p)
    if not (torch.equal(F.pad(images, lib_pad, mode="replicate"), ip)
            and torch.equal(F.pad(masks, lib_pad, mode="replicate"), mp)):
        raise AssertionError("pad_replicate_valid != F.pad replicate at full "
                             "extents")
    library = time_ms(lambda: (F.pad(images, lib_pad, mode="replicate"),
                               F.pad(masks, lib_pad, mode="replicate")), 20)
    records["pad_replicate_valid"]["library_ms"] = library
    aff_bnd, aff_by, aff_term, _ = affinity_bound_ms(
        b * h * w, ip.numel() * 4 + aff.numel() * 2, len(offs))
    # the resident diffusion's bound here: the affinity stack (39 MB) fits
    # the 50 MiB L2, so it need be read from device memory once; each step
    # reads one canvas and writes the other (2 x 5.8 MB). Twenty reads of
    # the stack (the eval shape's count) are logged beside it
    canvas_bytes = 2 * mp.numel() * 2
    bnd, by = bound_ms(PAR_ITERS * 2 * aff.numel() * c,
                       aff.numel() * 2 + PAR_ITERS * canvas_bytes)
    every, _ = bound_ms(0, PAR_ITERS * (aff.numel() * 2 + canvas_bytes))
    log(f"kernel fast train PAR images {tuple(images.shape)} -> "
        f"{tuple(ip.shape)}, masks {tuple(masks.shape)} -> {tuple(mp.shape)},"
        f" aff {tuple(aff.shape)}, resident iters={PAR_ITERS}: max_abs_err "
        + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
        + f" resident vs {PAR_ITERS} step launches={err_steps:.3g}"
        + f" (tol {TOL_PAR_BF16}; affinity 2^-7 |ref| + 2^-126) kernel_ms "
        + " ".join(f"{k}={v:.4f}" for k, v in ms.items())
        + f" pad-clamp library_ms (F.pad replicate, both)={library:.4f}"
        + f" affinity bound_ms={aff_bnd:.4f} ({aff_by}: {aff_term})"
        + f" resident bound_ms={bnd:.4f} ({by}; stack read every step "
        f"{every:.4f})")
    if not (errs["pad_replicate_valid"] <= TOL_PAR_BF16
            and bf16_within_ulp(aff, aff_ref)
            and errs["par_diffuse_valid_resident"] <= TOL_PAR_BF16
            and err_steps <= TOL_PAR_BF16):
        raise AssertionError(f"fast train PAR kernels off: {errs}")
    for name, e in errs.items():
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], e)


# VOC-typical label extents (h, w): landscape and portrait images
VOC_EXTENTS = [(375, 500), (333, 500), (500, 375), (375, 500), (366, 500),
               (500, 333), (375, 500), (353, 500)]


def synthetic_samples(n: int, num_fg: int, seed: int,
                      extents=VOC_EXTENTS, max_classes: int = 3) -> list[dict]:
    """Seeded VOC-sized eval samples (or train crops, with extents [(320,
    320)]): textured background with coloured elliptical blobs of 1 to
    `max_classes` classes, exact labels, image-level labels."""
    rng = np.random.default_rng(seed)
    palette = rng.integers(100, 256, (num_fg + 1, 3))
    samples = []
    for i in range(n):
        h, w = extents[i % len(extents)]
        image = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
        label = np.zeros((h, w), np.int32)
        classes = rng.choice(np.arange(1, num_fg + 1),
                             size=int(rng.integers(1, max_classes + 1)),
                             replace=False)
        ys, xs = np.ogrid[:h, :w]
        for c in classes:
            cy, cx = rng.integers(h // 6, 5 * h // 6), rng.integers(
                w // 6, 5 * w // 6)
            ry, rx = rng.integers(h // 8, h // 3), rng.integers(w // 8, w // 3)
            blob = ((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 <= 1
            image[blob] = palette[c]
            label[blob] = c
        cls_label = np.zeros(num_fg, np.float32)
        present = np.unique(label)
        cls_label[present[present > 0] - 1] = 1.0
        samples.append(dict(name=f"synth_{i:04d}", image=image, label=label,
                            cls_label=cls_label))
    return samples


def text_bank(cfg, seed: int) -> torch.Tensor:
    """Seeded normalised text bank (num_fg + 25 VOC background classes,
    embed_dim), as the JAX package's CLIs make it under --random-init."""
    rng = np.random.default_rng(seed)
    bank = rng.normal(size=(cfg.num_fg + 25, cfg.clip.embed_dim)).astype(
        np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    return torch.from_numpy(bank)


def _kernel_wrappers():
    from excel_tpu_torch.models.attention_kernels import (
        fused_plain_attention, fused_surgery_attention)
    from excel_tpu_torch.ops import par_kernels as pk
    return {"plain_attention": fused_plain_attention,
            "surgery_attention": fused_surgery_attention,
            "par_diffuse": pk.par_diffuse,
            "pad_replicate_valid": pk.pad_replicate_valid,
            "par_affinity": pk.par_affinity,
            "par_diffuse_padded_valid": pk.par_diffuse_padded_valid,
            "par_diffuse_valid_resident": pk.par_diffuse_valid_resident}


def reset_launches() -> None:
    """Every wrapper's launch count (and the counts by Pallas row and by
    type) to 0, just before a main path runs."""
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    for name in ("plain_attention", "surgery_attention"):
        by_row = wrappers[name].launches_by_row
        for row in by_row:
            by_row[row] = 0
    wrappers["par_diffuse"].launches_by_type.clear()


# launches per line of the JSON kernel table (per Pallas function) over all
# main paths, each read just after its path ran
ROW_LAUNCHES: dict = {}
CRF_K = 72      # offsets of the mean-field CRF's message pass (PAR: 48)


def read_launches(preset: str, training: bool) -> dict:
    """Each wrapper's launches since `reset_launches` (returned), added to
    ROW_LAUNCHES under the Pallas function whose route they took: the
    attention wrappers' own attribution (`launches_by_row`: plain without
    weights at N <= 512 is row 2, else row 1; surgery at N <= 640 row 3,
    else row 4), counted per dtype; the fp32 step of PAR on valid extents
    (eval) row 5 and on full extents (training's pseudo-labels) row 8, the
    CRF's message pass (72 offsets) row 5 at its own lines, fp32 and bf16;
    likewise the bf16 single step, row 7 or row 6."""
    wrappers = _kernel_wrappers()
    counts = {name: fn.launches for name, fn in wrappers.items()}
    sfx = "_bf16" if preset == "fast" else ""
    plain = wrappers["plain_attention"].launches_by_row
    surgery = wrappers["surgery_attention"].launches_by_row
    by_type = wrappers["par_diffuse"].launches_by_type
    par_steps = sum(v for (_, k), v in by_type.items() if k != CRF_K)
    rows = {f"plain_attention{sfx}": plain["_plain_kernel"],
            f"plain_attention_rows_hb{sfx}": plain["_plain_kernel_rows_hb"],
            f"surgery_attention{sfx}": surgery["_kernel"],
            f"surgery_attention_rows{sfx}": surgery["_kernel_rows"],
            "par_diffuse_padded_hcw" if training else "par_diffuse": par_steps,
            "par_diffuse_crf": by_type[torch.float32, CRF_K],
            "par_diffuse_crf_bf16": by_type[torch.bfloat16, CRF_K],
            "par_diffuse_padded" if training else "par_diffuse_padded_valid":
                counts["par_diffuse_padded_valid"]}
    rows.update({name: counts[name] for name in (
        "pad_replicate_valid", "par_affinity", "par_diffuse_valid_resident")})
    for name, n in rows.items():
        ROW_LAUNCHES[name] = ROW_LAUNCHES.get(name, 0) + n
    return counts


# launches of each kernel wrapper per batch of each slice's main path:
# blocks 0-6 (plain attention), blocks 7-11 (surgery attention), then PAR:
# fp32, 20 steps; fast, pad-clamp of the images and of the masks, the
# affinity, and one resident launch of all 20 steps
LAUNCHES_PER_BATCH = {
    "fp32": {"plain_attention": 7, "surgery_attention": 5, "par_diffuse": 20,
             "pad_replicate_valid": 0, "par_affinity": 0,
             "par_diffuse_padded_valid": 0, "par_diffuse_valid_resident": 0},
    "fast": {"plain_attention": 7, "surgery_attention": 5, "par_diffuse": 0,
             "pad_replicate_valid": 2, "par_affinity": 1,
             "par_diffuse_padded_valid": 0, "par_diffuse_valid_resident": 1},
}


def slice_setup(preset: str, n_samples: int):
    """(cfg, params, text bank, samples) of a slice: seeded random weights
    at full voc_config() width; under the fast preset the matmul weights
    are cast to bf16 once, as the JAX package's CLIs and bench do."""
    from excel_tpu_torch.config import fast, voc_config
    from excel_tpu_torch.models.params import (cast_matmul_weights,
                                               init_clip_params)

    cfg = voc_config() if preset == "fp32" else fast(voc_config())
    clip = init_clip_params(cfg.clip, torch.Generator().manual_seed(0),
                            device="cuda")
    if preset == "fast":
        clip = cast_matmul_weights(clip, torch.bfloat16)
    text = text_bank(cfg, seed=0).cuda()
    return cfg, {"clip": clip}, text, synthetic_samples(n_samples,
                                                        cfg.num_fg, seed=0)


def phase_slice(preset: str, n_samples: int = 32, batch: int = 16):
    """run_lam_eval of one preset at full voc_config() width; returns
    (launch counts, params, text bank, cfg, samples)."""
    from excel_tpu_torch.engine.evaluate import _bucketed_batches, run_lam_eval

    cfg, params, text, samples = slice_setup(preset, n_samples)
    n_batches = sum(1 for _ in _bucketed_batches(
        samples, batch, cfg.data.eval_pad, cfg.refine.slot_buckets,
        cfg.num_fg))
    # warm-up (cuBLAS handles, allocator) on a part of the data
    run_lam_eval(params, samples[:batch], text, cfg, batch_size=batch,
                 device="cuda")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = run_lam_eval(params, samples, text, cfg, batch_size=batch,
                          device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_launches(preset, training=False)
    name = "fast(voc_config())" if preset == "fast" else "voc_config()"
    log(f"slice {preset}: run_lam_eval {name} encoder "
        f"{str(cfg.clip.compute_dtype).split('.')[-1]} PAR "
        f"{'bf16' if cfg.refine.par_bf16 else 'fp32'} ViT-B/16 "
        f"N={cfg.clip.tokens} samples={n_samples} batch={batch} batches="
        f"{n_batches} seconds={dt:.3f} img_per_s={n_samples / dt:.3f} "
        f"(padded slots {n_batches * batch}) miou={scores['miou']:.4f} "
        f"pAcc={scores['pAcc']:.4f}")
    log(f"slice {preset} launches: " + json.dumps(counts))
    for name, per_batch in LAUNCHES_PER_BATCH[preset].items():
        if counts[name] != per_batch * n_batches:
            raise AssertionError(
                f"{preset} slice, {name}: {counts[name]} launches, expected "
                f"{per_batch} x {n_batches} batches")
    if not (0.0 <= scores["miou"] <= 1.0 and np.isfinite(scores["pAcc"])):
        raise AssertionError(f"bad scores {scores['miou']} {scores['pAcc']}")
    return counts, params, text, cfg, samples


def _device_profile(step):
    """(device ms, events by kernel) of one profiled call of `step`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    return sum(e.self_device_time_total for e in events) / 1e3, events


def phase_profile(preset, params, text, cfg, samples,
                  batch: int = 16) -> None:
    """Device time by kernel over one main-path batch (torch.profiler)."""
    from excel_tpu_torch.engine.evaluate import (
        _bucketed_batches, _prep_batch, _slots_bucket, lam_eval_hist_step)
    from excel_tpu_torch.utils.metrics import init_hist

    canvas, group = next(_bucketed_batches(
        samples, batch, cfg.data.eval_pad, cfg.refine.slot_buckets,
        cfg.num_fg))
    t0 = time.perf_counter()
    images, cls, labels, valid = _prep_batch(group, cfg.clip.image_size,
                                             canvas)
    prep_ms = (time.perf_counter() - t0) * 1e3
    slots = _slots_bucket(cls, cfg.num_fg, cfg.refine.slot_buckets)
    args = [torch.from_numpy(a).cuda() for a in (images, cls, labels, valid)]
    hist = init_hist(cfg.num_classes, "cuda")

    def step():
        return lam_eval_hist_step(hist, params, args[0], args[1], args[2],
                                  args[3], text, cfg, canvas,
                                  class_slots=slots)

    wall = median_wall_ms(step)
    device_ms, events = _device_profile(step)
    log(f"profile {preset}: one batch of {batch} canvas={canvas} "
        f"slots={slots} wall_ms={wall:.2f} (median of 3, profiler off) device_ms="
        f"{device_ms:.2f} (profiled run) busy_share="
        f"{device_ms / wall:.3f} host_prep_ms={prep_ms:.2f} "
        f"(_prep_batch: numpy resize of the batch's images)")
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    for e in top:
        log(f"profile {preset}: {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<5d} {e.key[:90]}")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def phase_card_vs_cpu(preset, params, text, cfg, samples,
                      bound: float) -> float:
    """One batch of 2 through lam_eval_step on the card (kernels) and on
    the CPU (plain versions); share of valid pixels with equal labels."""
    from excel_tpu_torch.engine.evaluate import (
        _bucketed_batches, _prep_batch, _slots_bucket, lam_eval_step)

    canvas, group = next(_bucketed_batches(
        samples, 2, cfg.data.eval_pad, cfg.refine.slot_buckets, cfg.num_fg))
    images, cls, labels, valid = _prep_batch(group, cfg.clip.image_size,
                                             canvas)
    slots = _slots_bucket(cls, cfg.num_fg, cfg.refine.slot_buckets)
    arrays = [torch.from_numpy(a) for a in (images, cls, valid)]
    t0 = time.perf_counter()
    on_card = lam_eval_step(params, *[a.cuda() for a in arrays], text, cfg,
                            canvas, class_slots=slots).cpu()
    t1 = time.perf_counter()
    on_cpu = lam_eval_step(_tree_to(params, "cpu"), *arrays, text.cpu(), cfg,
                           canvas, class_slots=slots)
    t2 = time.perf_counter()
    mask = torch.from_numpy(labels != 255)
    agree = float((on_card == on_cpu)[mask].float().mean())
    log(f"card_vs_cpu {preset}: batch=2 canvas={canvas} slots={slots} "
        f"valid_pixels={int(mask.sum())} label_agreement={agree:.6f} (bound "
        f">= {bound}) card_s={t1 - t0:.2f} cpu_s={t2 - t1:.2f}")
    if not agree >= bound:
        raise AssertionError(f"card and CPU labels agree on {agree:.4f} of "
                             f"the valid pixels")
    return agree


# launches of each kernel wrapper per train step (per batch of the
# validation and trained-LAM sweeps): pre-calibration (and validation), one
# encoder pass; calibrated (and the trained LAM sweep, whose batch is
# [x, flip x]), the head's pass and the calibrated pass; then PAR as in the
# eval slices (full extents in training)
TRAIN_LAUNCHES = {
    (preset, calibrated): {
        name: (n * (2 if calibrated and "attention" in name else 1))
        for name, n in LAUNCHES_PER_BATCH[preset].items()}
    for preset in ("fp32", "fast") for calibrated in (False, True)}


def train_setup(preset: str):
    """(cfg, clip params, head, text bank, crops) of the training slice:
    voc_config() or its fast preset with the phase thresholds cut to
    TRAIN_PHASE_STEPS, seeded random CLIP (seed 0) and head (seed 1)
    weights, 16 synthetic 320 px uint8 crops with 1-3 classes."""
    import dataclasses

    from excel_tpu_torch.config import fast, voc_config
    from excel_tpu_torch.models.head import init_head_params
    from excel_tpu_torch.models.params import (cast_matmul_weights,
                                               init_clip_params)

    cfg = voc_config() if preset == "fp32" else fast(voc_config())
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, warmup_iters=2, lvc_calibrate_iter=TRAIN_PHASE_STEPS,
        seg_affinity_iter=2 * TRAIN_PHASE_STEPS,
        max_iters=3 * TRAIN_PHASE_STEPS))
    clip = init_clip_params(cfg.clip, torch.Generator().manual_seed(0),
                            device="cuda")
    if preset == "fast":
        clip = cast_matmul_weights(clip, torch.bfloat16)
    head = init_head_params(cfg.head, cfg.num_classes,
                            torch.Generator().manual_seed(1), device="cuda")
    crops = synthetic_samples(4 * TRAIN_B, cfg.num_fg, seed=1,
                              extents=[(TRAIN_CROP, TRAIN_CROP)])
    images = torch.from_numpy(np.stack([s["image"] for s in crops]))
    cls = torch.from_numpy(np.stack([s["cls_label"] for s in crops]))
    return cfg, clip, head, text_bank(cfg, seed=0).cuda(), images, cls


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def phase_train(preset: str):
    """The LVC head's training at full ViT-B/16 width, B=4, crop 320, as
    the JAX package's train loop drives it (per step: the phase, the step
    function of the (phase, slot bucket) cache, the step), through all
    three phases. Checks each step's launch counts, finite losses, that
    every head parameter moved and every CLIP tensor did not; profiles one
    production-phase step. Returns (cfg, clip, state, text, crops)."""
    from torch.profiler import ProfilerActivity, profile

    from excel_tpu_torch.engine.train import (TrainStepCache, _phase,
                                              init_train_state,
                                              step_generator)

    cfg, clip, head, text, images, cls = train_setup(preset)
    clip_before = [t.clone() for t in _leaves(clip)]
    head_before = {k: v.clone() for k, v in head.state_dict().items()}
    state = init_train_state(head, cfg.train)
    steps = TrainStepCache(cfg)
    images_d, cls_d = images.cuda(), cls.cuda()
    total: dict = {}
    walls: dict = {}
    torch.cuda.reset_peak_memory_stats()

    def batch(i):
        s = slice((i % 4) * TRAIN_B, (i % 4 + 1) * TRAIN_B)
        return images_d[s], cls_d[s], cls[s]

    for n_iter in range(cfg.train.max_iters):
        imgs, cls_b, cls_host = batch(n_iter)
        phase = _phase(cfg, n_iter)
        step_fn = steps(phase, cls_host)
        gen = step_generator(cfg.train, n_iter, "cuda")
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, clip, imgs, cls_b, text, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = read_launches(preset, training=True)
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
        walls.setdefault(phase, []).append(wall)
        # the losses are 0-d device tensors: read here, where they are logged
        metrics = {k: float(v) for k, v in metrics.items()}
        log(f"train {preset} step {n_iter} phase={phase} slots="
            f"{steps.slots_for(cls_host)} wall_ms={wall:.2f} "
            + " ".join(f"{k}={v:.6g}" for k, v in metrics.items())
            + " launches=" + json.dumps(
                {k: v for k, v in counts.items() if v}))
        if counts != TRAIN_LAUNCHES[preset, phase[0]]:
            raise AssertionError(f"train {preset} step {n_iter}: launches "
                                 f"{counts}, expected "
                                 f"{TRAIN_LAUNCHES[preset, phase[0]]}")
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"train {preset}: non-finite {metrics}")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = [k for k, v in state.head.state_dict().items()
             if not torch.equal(v, head_before[k])]
    if len(moved) != len(head_before):
        raise AssertionError(f"train {preset}: {len(head_before) - len(moved)}"
                             f" head tensors did not move")
    if not all(torch.equal(a, b) for a, b in zip(_leaves(clip),
                                                  clip_before)):
        raise AssertionError(f"train {preset}: a CLIP tensor changed")
    del clip_before
    for phase, w in sorted(walls.items()):
        log(f"train {preset} phase={phase}: step wall_ms median="
            f"{statistics.median(w[1:]):.2f} of {len(w) - 1} (first "
            f"{w[0]:.2f}, allocations)")
    log(f"train {preset}: {cfg.train.max_iters} steps B={TRAIN_B} crop="
        f"{TRAIN_CROP} head tensors moved {len(moved)}/{len(head_before)}, "
        f"CLIP tensors unchanged bit for bit, peak_allocated_gb="
        f"{peak_gb:.2f}, launches " + json.dumps(total))

    # one production-phase step, profiled
    imgs, cls_b, cls_host = batch(state.step)
    phase = (True, True)
    step_fn = steps(phase, cls_host)
    gen = step_generator(cfg.train, state.step, "cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, clip, imgs, cls_b, text, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    wall_off = statistics.median(walls[phase][1:])
    log(f"profile train {preset}: one step phase={phase} device_ms="
        f"{device_us / 1e3:.2f} (profiled run, wall_ms={wall:.2f}) busy_share="
        f"{device_us / 1e3 / wall_off:.3f} (of the phase's median wall_ms="
        f"{wall_off:.2f}, profiler off)")
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        log(f"profile train {preset}: {e.self_device_time_total / 1e3:9.3f} "
            f"ms x{e.count:<5d} {e.key[:90]}")
    return cfg, clip, state, text, (images, cls)


def same_input_agreement(cfg, clip, head, images_u8, cls, text,
                         slots) -> float:
    """Share of pixels on which the card's pseudo-labels of one calibrated
    step equal the CPU's `pseudo_labels` run on the card's own LAMs,
    attention stack, attn_pred and PAR guidance."""
    from excel_tpu_torch.engine.pipeline import (denormalize_images,
                                                 normalize_images,
                                                 pseudo_labels)
    from excel_tpu_torch.models.excel import excel_forward

    images = normalize_images(images_u8.cuda())
    params = {"clip": clip, "head": head}
    with torch.no_grad():
        out = excel_forward(params, images, text, cfg, attn_mode="stack")
        lams = excel_forward(params, images, text, cfg, ex_feats=out.fused)
    inputs = (lams, out.attn_weights,
              denormalize_images(images).permute(0, 3, 1, 2), cls.cuda(),
              out.attn_pred)
    labels = []
    for dev in ("cuda", "cpu"):
        lam, attn, guide, c, pred = (t.to(dev) for t in inputs)
        labels.append(pseudo_labels(
            lam, attn, guide, c, cfg, tuple(images.shape[1:3]),
            cfg.refine.caa_threshold, seg_attn=pred,
            class_slots=slots).cpu())
    return float((labels[0] == labels[1]).float().mean())


def phase_train_card_vs_cpu(preset, cfg, clip, state, text, crops,
                            bound: float) -> None:
    """One calibrated step's forward and backward at B=2 on the card
    (kernels) and on the CPU (plain versions) from the same head:
    pseudo-labels, losses and the head's gradients, on two of the training
    crops (1-3 classes) and on two crops of one class each; and
    `denormalize_images` (the PAR guidance of training) on all 256 x 3
    byte values. The loss and gradient bounds hold on both crop sets, the
    label bound on the one-class crops in both presets and on the training
    crops in fp32. Under the fast preset the training crops' label
    agreement is reported, not bounded: where an image has two or more
    classes, a random-weight model's class maps tie over whole regions, and
    the bf16 encoder's rounding differences between cuBLAS and the CPU
    (about 1% of the LAMs' range) decide those regions. So on both crop
    sets and in both presets the card's pseudo-labels are also held, within
    MIN_SAME_INPUT_AGREEMENT, against the CPU's `pseudo_labels` on the
    card's own LAMs, attention and attn_pred: the slot compaction, the
    per-class PAR channels and the labels' argmax, the same inputs on both
    sides."""
    import copy

    from excel_tpu_torch.engine.pipeline import (denormalize_images,
                                                 normalize_images)
    from excel_tpu_torch.engine.train import TrainStepCache, train_losses

    one = synthetic_samples(2, cfg.num_fg, seed=3,
                            extents=[(TRAIN_CROP, TRAIN_CROP)], max_classes=1)
    batches = {"training crops": (crops[0][:2], crops[1][:2]),
               "one-class crops": (
                   torch.from_numpy(np.stack([s["image"] for s in one])),
                   torch.from_numpy(np.stack([s["cls_label"] for s in one])))}
    head_cpu, clip_cpu = copy.deepcopy(state.head).cpu(), _tree_to(clip, "cpu")
    for what, (images, cls) in batches.items():
        slots = TrainStepCache(cfg).slots_for(cls)
        out = {}
        for dev, head, params in (("cuda", state.head, clip),
                                  ("cpu", head_cpu, clip_cpu)):
            t0 = time.perf_counter()
            head.zero_grad(set_to_none=True)
            total, l_seg, l_aff, pseudos = train_losses(
                head, params, images.to(dev), cls.to(dev), text.to(dev),
                None, cfg, calibrated=True, seg_affinity=True,
                class_slots=slots)
            total.backward()
            grad = torch.cat([p.grad.flatten()
                              for p in head.parameters()]).cpu()
            head.zero_grad(set_to_none=True)
            out[dev] = (l_seg.item(), l_aff.item(), pseudos.cpu(), grad,
                        time.perf_counter() - t0)
        (s_c, a_c, p_c, g_c, t_c), (s_h, a_h, p_h, g_h, t_h) = (out["cuda"],
                                                                out["cpu"])
        agree = float((p_c == p_h).float().mean())
        rel = [abs(s_c - s_h) / abs(s_h), abs(a_c - a_h) / abs(a_h)]
        g_rel = float((g_c - g_h).norm() / g_h.norm())
        same = same_input_agreement(cfg, clip, state.head, images, cls, text,
                                    slots)
        label_bounded = preset == "fp32" or what == "one-class crops"
        bounds = (f"bounds: labels >= {bound}" if label_bounded
                  else "labels reported") + (
            f", same-input labels >= {MIN_SAME_INPUT_AGREEMENT}, losses "
            f"{TRAIN_LOSS_RTOL}, gradient {TRAIN_GRAD_RTOL}")
        log(f"train_card_vs_cpu {preset} {what} (classes "
            f"{cls.sum(1).int().tolist()}): calibrated step B=2 slots={slots} "
            f"pseudo_label_agreement={agree:.6f} same_input_agreement="
            f"{same:.6f} seg_loss {s_c:.7g}/"
            f"{s_h:.7g} rel={rel[0]:.3g} diver_loss {a_c:.7g}/{a_h:.7g} "
            f"rel={rel[1]:.3g} head_grad rel_norm_diff={g_rel:.3g} "
            f"({bounds}) card_s={t_c:.2f} cpu_s={t_h:.2f}")
        if not ((agree >= bound or not label_bounded)
                and same >= MIN_SAME_INPUT_AGREEMENT
                and max(rel) <= TRAIN_LOSS_RTOL and g_rel <= TRAIN_GRAD_RTOL):
            raise AssertionError(f"train card vs CPU ({preset}, {what}) "
                                 f"out of bounds")
    u8 = torch.arange(256, dtype=torch.uint8)[None, :, None].expand(
        1, 256, 3).contiguous()
    d_cpu = denormalize_images(normalize_images(u8))
    d_card = denormalize_images(normalize_images(u8.cuda())).cpu()
    same = int((d_cpu == d_card).sum())
    back = int((torch.round(d_cpu * 255).to(torch.uint8) == u8).sum())
    log(f"denormalize_images {preset}: card == CPU on {same}/768 values; "
        f"{back}/768 recover their byte")
    if same != 768:
        raise AssertionError("denormalize_images: card and CPU differ")


def phase_trained_eval(preset, cfg, clip, state, text,
                       n_samples: int = 8, batch: int = 4) -> None:
    """In-training validation (`run_validation`) and the trained LAM sweep
    (`run_lam_eval(mode="trained")`) with the trained head over synthetic
    VOC-sized samples, launch counts per batch checked."""
    from excel_tpu_torch.engine.evaluate import (_bucketed_batches,
                                                 run_lam_eval, run_validation)

    params = {"clip": clip, "head": state.head}
    samples = synthetic_samples(n_samples, cfg.num_fg, seed=2)
    n_batches = sum(1 for _ in _bucketed_batches(
        samples, batch, cfg.data.eval_pad, cfg.refine.slot_buckets,
        cfg.num_fg))
    sweeps =(("validation", False, lambda s: run_validation(
                  params, s, text, cfg, batch_size=batch)),
              ("trained_lam", True, lambda s: run_lam_eval(
                  params, s, text, cfg, mode="trained", batch_size=batch)))
    for what, calibrated, run in sweeps:
        run(samples[:batch])                       # warm-up
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = run(samples)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_launches(preset, training=False)
        for s in scores if isinstance(scores, tuple) else (scores,):
            if not (0.0 <= s["miou"] <= 1.0 and np.isfinite(s["pAcc"])):
                raise AssertionError(f"{what} {preset}: bad scores {s}")
        miou = ([round(s["miou"], 4) for s in scores]
                if isinstance(scores, tuple) else round(scores["miou"], 4))
        log(f"{what} {preset}: samples={n_samples} batch={batch} batches="
            f"{n_batches} seconds={dt:.3f} img_per_s={n_samples / dt:.3f} "
            f"miou={miou} launches=" + json.dumps(
                {k: v for k, v in counts.items() if v}))
        for name, per_batch in TRAIN_LAUNCHES[preset, calibrated].items():
            if counts[name] != per_batch * n_batches:
                raise AssertionError(
                    f"{what} {preset}, {name}: {counts[name]} launches, "
                    f"expected {per_batch} x {n_batches} batches")


def check_crf_diffuse() -> dict:
    """Row 5's kernel at the mean-field CRF's shapes (72 offsets up to 55 px,
    CRF_SHAPES), fp32 and bf16, each against its plain version on the same
    inputs: marginals Q over the channels and non-negative pairwise weights
    that sum to bi_w = 4 a pixel. fp32 sums in the plain version's order and
    bf16 keeps its rounding points, so both are held bit for bit. Returns
    the records of the first shape, the VOC MSC batch's."""
    from excel_tpu_torch.ops import par_kernels as pk
    from excel_tpu_torch.ops.crf_tpu import DEFAULT_DILATIONS, _offsets

    gen = torch.Generator(device="cuda").manual_seed(4)
    offs = _offsets(DEFAULT_DILATIONS)
    k = len(offs)
    offsets = pk.offsets_tensor(offs, "cuda")
    records = {}
    for b, c, h, w in CRF_SHAPES:
        q = torch.rand((b, c, h, w), device="cuda", generator=gen)
        q = q / q.sum(dim=1, keepdim=True)
        aff = torch.rand((b, k, h, w), device="cuda", generator=gen)
        aff = 4.0 * aff / aff.sum(dim=1, keepdim=True)
        for dtype, name in ((torch.float32, "par_diffuse_crf"),
                            (torch.bfloat16, "par_diffuse_crf_bf16")):
            qd, ad = q.to(dtype).contiguous(), aff.to(dtype).contiguous()
            got = pk.par_diffuse(qd, ad, offsets)
            err = max_err(got.float(),
                          pk.par_diffuse_reference(qd, ad, offsets).float())
            if got.dtype != dtype or not err <= TOL_PAR_STEP:
                raise AssertionError(f"{name} {(b, c, h, w)}: max err {err}")
            kernel = time_ms(lambda: pk.par_diffuse(qd, ad, offsets), 10)
            plain = time_ms(lambda: pk.par_diffuse_reference(qd, ad, offsets),
                            2)
            bnd, by = diffuse_bound_ms(b, c, h, w, k, qd.element_size())
            log(f"kernel {name} (row 5, the CRF's message pass) B={b} C={c} "
                f"K={k} {h}x{w} pad={max(DEFAULT_DILATIONS)} (staged "
                f"{pk.staged_pad(tuple(offs), c, qd.element_size())}) "
                f"{str(dtype).split('.')[-1]}: max_abs_err={err:.3g} (tol "
                f"{TOL_PAR_STEP}) kernel_ms={kernel:.4f} plain_ms={plain:.4f} "
                f"library_ms=None bound_ms={bnd:.4f} ({by})")
            if (b, c, h, w) == CRF_SHAPES[0]:
                records[name] = dict(ms=kernel, plain_ms=plain,
                                     library_ms=None, bound_ms=bnd,
                                     bound_by=by, max_abs_err=err)
            else:
                records[name]["max_abs_err"] = max(
                    records[name]["max_abs_err"], err)
    return records


# label extents of the MSC slice's samples: one full batch on the 384 x 512
# canvas and one on the 512 x 384 canvas
MSC_EXTENTS = [(375, 500), (366, 500), (375, 500), (353, 500),
               (500, 375), (500, 333), (500, 375), (500, 366)]


def msc_setup(preset: str):
    """(cfg, params, text bank, samples) of the MSC slice: seeded random
    CLIP (seed 0; matmul weights cast to bf16 under the fast preset) and
    head (seed 1) at full voc_config() width, MSC_SAMPLES synthetic
    samples."""
    from excel_tpu_torch.config import fast, voc_config
    from excel_tpu_torch.models.head import init_head_params
    from excel_tpu_torch.models.params import (cast_matmul_weights,
                                               init_clip_params)

    cfg = voc_config() if preset == "fp32" else fast(voc_config())
    clip = init_clip_params(cfg.clip, torch.Generator().manual_seed(0),
                            device="cuda")
    if preset == "fast":
        clip = cast_matmul_weights(clip, torch.bfloat16)
    head = init_head_params(cfg.head, cfg.num_classes,
                            torch.Generator().manual_seed(1), device="cuda")
    head.eval()
    samples = synthetic_samples(MSC_SAMPLES, cfg.num_fg, seed=4,
                                extents=MSC_EXTENTS)
    return (cfg, {"clip": clip, "head": head}, text_bank(cfg, seed=0).cuda(),
            samples)


def msc_batch(cfg, samples, batch: int):
    """The first canvas bucket's batch, prepared for `msc_hist_step` with
    the CRF, as CPU tensors: (canvas, host preparation ms, (labels,
    valid_hw, canvas images), per-scale images, per-scale configs,
    keep_flips)."""
    from excel_tpu_torch.engine.evaluate import (_bucketed_batches,
                                                 _prep_msc_batch, _scale_cfgs)

    canvas, group = next(_bucketed_batches(samples, batch, cfg.data.eval_pad))
    t0 = time.perf_counter()
    prep, scale_images = _prep_msc_batch(group, cfg.clip.image_size, canvas,
                                         MSC_SCALES, with_canvas_images=True)
    prep_ms = (time.perf_counter() - t0) * 1e3
    return (canvas, prep_ms, tuple(torch.from_numpy(a) for a in prep[2:]),
            tuple(torch.from_numpy(x) for x in scale_images),
            _scale_cfgs(cfg, cfg.clip.image_size, MSC_SCALES),
            tuple(sc != 1.0 for sc in MSC_SCALES))


def phase_msc(preset: str):
    """`run_msc_seg_eval` of one preset at full width, without and with the
    on-device CRF (`long_range` on, the default): launch counts per batch
    by Pallas row, scores, img/s; then one batch's step profiled (wall,
    device time, busy share), the host's preparation time of a batch, and
    the CRF's build against its message passes. Returns (cfg, params, text,
    samples)."""
    import dataclasses

    from excel_tpu_torch.engine.evaluate import (_bucketed_batches,
                                                 msc_hist_step,
                                                 run_msc_seg_eval)
    from excel_tpu_torch.models.attention_kernels import (
        fused_plain_attention, fused_surgery_attention)
    from excel_tpu_torch.ops import par_kernels as pk
    from excel_tpu_torch.ops.crf_tpu import crf_meanfield_cfg
    from excel_tpu_torch.utils.metrics import init_hist

    cfg, params, text, samples = msc_setup(preset)
    n_batches = sum(1 for _ in _bucketed_batches(samples, MSC_B,
                                                 cfg.data.eval_pad))
    msg = torch.bfloat16 if cfg.crf.msg_bf16 else torch.float32
    if not cfg.crf.long_range:
        raise AssertionError("the CRF's long-range level is off")
    for crf in (False, True):
        run_msc_seg_eval(params, samples, text, cfg, scales=MSC_SCALES,
                         batch_size=MSC_B, crf_tpu=crf)        # warm-up
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = run_msc_seg_eval(params, samples, text, cfg,
                                  scales=MSC_SCALES, batch_size=MSC_B,
                                  crf_tpu=crf)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        by_row = dict(fused_plain_attention.launches_by_row,
                      **fused_surgery_attention.launches_by_row)
        by_type = dict(pk.par_diffuse.launches_by_type)
        counts = read_launches(preset, training=False)
        log(f"msc {preset} crf_tpu={crf}: run_msc_seg_eval scales="
            f"{MSC_SCALES} x {cfg.clip.image_size} px samples={len(samples)} "
            f"batch={MSC_B} batches={n_batches} seconds={dt:.3f} img_per_s="
            f"{len(samples) / dt:.3f} miou={scores['miou']:.4f} pAcc="
            f"{scores['pAcc']:.4f} launches by row=" + json.dumps(by_row)
            + " par_diffuse=" + json.dumps(
                {f"{str(d).split('.')[-1]} K={k}": v
                 for (d, k), v in by_type.items()}))
        want_rows = {r: v * n_batches for r, v in MSC_ROW_LAUNCHES.items()}
        want_crf = {(msg, CRF_K): CRF_ITERS * n_batches} if crf else {}
        others = {k: v for k, v in counts.items() if v and k not in (
            "plain_attention", "surgery_attention", "par_diffuse")}
        if by_row != want_rows or by_type != want_crf or others:
            raise AssertionError(
                f"msc {preset} crf_tpu={crf}: launches by row {by_row} "
                f"(expected {want_rows}), par_diffuse {by_type} (expected "
                f"{want_crf}), other kernels {others}")
        if not (0.0 <= scores["miou"] <= 1.0 and np.isfinite(scores["pAcc"])):
            raise AssertionError(f"msc {preset}: bad scores {scores}")

    # one batch: host preparation, then the step with and without the CRF
    canvas, prep_ms, on_host, images, cfgs, keep = msc_batch(cfg, samples,
                                                             MSC_B)
    labels, valid, canvas_images = (a.cuda() for a in on_host)
    images = tuple(x.cuda() for x in images)
    hist = init_hist(cfg.num_classes, "cuda")
    for crf in (False, True):
        def step():
            return msc_hist_step(hist, params, images, labels, valid, text,
                                 cfgs, canvas, keep,
                                 canvas_images=canvas_images, use_crf=crf)

        wall = median_wall_ms(step)
        device_ms, events = _device_profile(step)
        log(f"profile msc {preset} crf_tpu={crf}: one batch of {MSC_B} "
            f"canvas={canvas} wall_ms={wall:.2f} (median of 3, profiler "
            f"off) device_ms={device_ms:.2f} (profiled run) busy_share="
            f"{device_ms / wall:.3f} host_prep_ms={prep_ms:.2f} "
            f"(_prep_msc_batch: {1 + len(MSC_SCALES)} numpy resizes an "
            f"image and the canvas copy)")
        for e in sorted(events, key=lambda e: e.self_device_time_total,
                        reverse=True)[:10]:
            log(f"profile msc {preset} crf_tpu={crf}: "
                f"{e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5d} "
                f"{e.key[:90]}")
    # the CRF alone on that batch: the build (pairwise weights, both
    # levels) against the CRF_ITERS message passes and updates
    probs = torch.softmax(torch.randn(
        (MSC_B, cfg.num_classes, *canvas), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(5)), dim=1)
    build_cfg = dataclasses.replace(cfg.crf, iters=0)
    with torch.inference_mode():
        build_ms = time_ms(lambda: crf_meanfield_cfg(
            canvas_images, probs, build_cfg, valid_hw=valid), 5)
        full_ms = time_ms(lambda: crf_meanfield_cfg(
            canvas_images, probs, cfg.crf, valid_hw=valid), 5)
        _, events = _device_profile(lambda: crf_meanfield_cfg(
            canvas_images, probs, cfg.crf, valid_hw=valid))
    kernel_ms = sum(e.self_device_time_total for e in events
                    if "par_diffuse" in e.key) / 1e3
    log(f"crf {preset}: crf_meanfield_cfg [{MSC_B}, {cfg.num_classes}, "
        f"{canvas[0]}, {canvas[1]}] messages "
        f"{str(msg).split('.')[-1]} long_range=True: total_ms={full_ms:.3f} "
        f"build_ms={build_ms:.3f} (iters=0) message_and_update_ms="
        f"{full_ms - build_ms:.3f} of which the diffusion kernel x"
        f"{CRF_ITERS} = {kernel_ms:.3f} ms (profiled)")
    return cfg, params, text, samples


def phase_lam_crf(preset, params, text, cfg, samples, batch: int = 16):
    """The LAM sweep with the on-device CRF branch,
    `run_lam_eval(crf_tpu=True)`, on the eval slice's samples: returns the
    pair of scores; per batch the eval slice's launches plus CRF_ITERS of
    row 5's kernel at 72 offsets (fp32 entry point, or bf16 under the fast
    preset)."""
    from excel_tpu_torch.engine.evaluate import _bucketed_batches, run_lam_eval
    from excel_tpu_torch.ops import par_kernels as pk

    n_batches = sum(1 for _ in _bucketed_batches(
        samples, batch, cfg.data.eval_pad, cfg.refine.slot_buckets,
        cfg.num_fg))
    msg = torch.bfloat16 if cfg.crf.msg_bf16 else torch.float32
    run_lam_eval(params, samples[:batch], text, cfg, batch_size=batch,
                 crf_tpu=True)                                 # warm-up
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, crf_scores = run_lam_eval(params, samples, text, cfg,
                                      batch_size=batch, crf_tpu=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    crf_launches = pk.par_diffuse.launches_by_type[msg, CRF_K]
    counts = read_launches(preset, training=False)
    log(f"lam_crf {preset}: run_lam_eval(crf_tpu=True) samples="
        f"{len(samples)} batch={batch} batches={n_batches} seconds={dt:.3f} "
        f"img_per_s={len(samples) / dt:.3f} miou={scores['miou']:.4f} "
        f"crf_miou={crf_scores['miou']:.4f} launches=" + json.dumps(counts)
        + f" of which the CRF's message pass {crf_launches}")
    want = dict(LAUNCHES_PER_BATCH[preset])
    want["par_diffuse"] += CRF_ITERS
    for name, per_batch in want.items():
        if counts[name] != per_batch * n_batches:
            raise AssertionError(
                f"lam_crf {preset}, {name}: {counts[name]} launches, "
                f"expected {per_batch} x {n_batches} batches")
    if crf_launches != CRF_ITERS * n_batches:
        raise AssertionError(f"lam_crf {preset}: {crf_launches} launches of "
                             f"the {msg} message pass")
    for s in (scores, crf_scores):
        if not (0.0 <= s["miou"] <= 1.0 and np.isfinite(s["pAcc"])):
            raise AssertionError(f"lam_crf {preset}: bad scores {s}")


def phase_msc_card_vs_cpu(preset, cfg, params, text, samples) -> None:
    """One MSC batch of 2 with the CRF through `msc_hist_step` (outputs
    returned) on the card (kernels) and on the CPU (plain versions). The
    fused pre-CRF logits: fp32 within MSC_LOGITS_RTOL of their range, bf16
    reported. The predictions: fp32 >= MIN_LABEL_AGREEMENT of the valid
    pixels; under the fast preset the figure is reported (the bf16
    encoder's rounding differs between cuBLAS and the CPU, and a
    random-weight head's classes lie close). In both presets the CRF and
    the argmax are held on the same input: the CPU's CRF + argmax on the
    card's own fused logits >= MIN_SAME_INPUT_AGREEMENT of the card's
    predictions."""
    import copy

    from excel_tpu_torch.engine.evaluate import canvas_argmax, msc_hist_step
    from excel_tpu_torch.ops.crf_tpu import crf_meanfield_cfg
    from excel_tpu_torch.utils.metrics import init_hist

    canvas, _, (labels, valid, canvas_images), images, cfgs, keep = msc_batch(
        cfg, samples, 2)
    cpu_params = {"clip": _tree_to(params["clip"], "cpu"),
                  "head": copy.deepcopy(params["head"]).cpu()}
    out = {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        t0 = time.perf_counter()
        hist, logits, preds = msc_hist_step(
            init_hist(cfg.num_classes, dev), p,
            tuple(x.to(dev) for x in images), labels.to(dev), valid.to(dev),
            text.to(dev), cfgs, canvas, keep,
            canvas_images=canvas_images.to(dev), use_crf=True,
            return_outputs=True)
        out[dev] = (hist.cpu(), logits.cpu(), preds.cpu(),
                    time.perf_counter() - t0)
    (h_c, l_c, p_c, t_c), (h_h, l_h, p_h, t_h) = out["cuda"], out["cpu"]
    mask = labels != 255
    inside = mask[:, None].expand_as(l_c)
    span = float(l_h[inside].max() - l_h[inside].min())
    logit_err = float((l_c - l_h)[inside].abs().max()) / span
    agree = float((p_c == p_h)[mask].float().mean())
    with torch.inference_mode():
        q = crf_meanfield_cfg(canvas_images, torch.softmax(l_c, dim=1),
                              cfg.crf, valid_hw=valid)
        same = float((canvas_argmax(q) == p_c)[mask].float().mean())
    fp32 = preset == "fp32"
    log(f"msc_card_vs_cpu {preset}: batch=2 canvas={canvas} scales="
        f"{MSC_SCALES} crf_tpu=True valid_pixels={int(mask.sum())} "
        f"fused_logits max_abs_err/range={logit_err:.3g} (range {span:.4g}; "
        + (f"bound {MSC_LOGITS_RTOL}" if fp32 else "reported")
        + f") pred_agreement={agree:.6f} ("
        + (f"bound >= {MIN_LABEL_AGREEMENT}" if fp32 else "reported")
        + f") same_input_agreement={same:.6f} (the CPU's CRF + argmax on the "
        f"card's logits; bound >= {MIN_SAME_INPUT_AGREEMENT}) hist pixels "
        f"{int(h_c.sum())}/{int(h_h.sum())} card_s={t_c:.2f} cpu_s={t_h:.2f}")
    if int(h_c.sum()) != int(mask.sum()) or int(h_h.sum()) != int(mask.sum()):
        raise AssertionError(f"msc_card_vs_cpu {preset}: hist pixel counts")
    if not torch.isfinite(l_c).all():
        raise AssertionError(f"msc_card_vs_cpu {preset}: non-finite logits")
    if not same >= MIN_SAME_INPUT_AGREEMENT or (fp32 and not (
            logit_err <= MSC_LOGITS_RTOL and agree >= MIN_LABEL_AGREEMENT)):
        raise AssertionError(f"msc_card_vs_cpu {preset}: out of bounds")


# the text bank on the card against the CPU: fp32 sums in another order on
# 512-wide unit rows
TEXT_BANK_TOL_FP32 = 1e-5
# fast: the bf16 text tower's GEMMs round their fp32 sums to bf16 after
# summing in another order than the CPU's; over 12 layers the banks may
# part by one bf16 ulp of the bank's largest magnitude (the bound the CPU
# tests hold the bf16 encoder to)
TEXT_BANK_ULPS_FAST = 1.0
CLI_SAMPLES = 8
# the kernel wrappers each CLI run must launch: the training-free LAM sweep
# with the on-device CRF (row 5 at the CRF's 72 offsets), the trained LAM
# sweep, the MSC sweep; fp32 PAR is row 5's step, fast PAR pad-clamp,
# affinity and the resident diffusion
CLI_KERNELS = {
    ("infer_lam", "fp32"): ("plain_attention", "surgery_attention",
                            "par_diffuse"),
    ("infer_lam", "fast"): ("plain_attention", "surgery_attention",
                            "par_diffuse", "pad_replicate_valid",
                            "par_affinity", "par_diffuse_valid_resident"),
    ("infer_lam_head", "fast"): ("plain_attention", "surgery_attention",
                                 "pad_replicate_valid", "par_affinity",
                                 "par_diffuse_valid_resident"),
    ("infer_seg", "fast"): ("plain_attention", "surgery_attention"),
}


@contextlib.contextmanager
def _patched(module, name: str, wrap):
    """module.<name> replaced by wrap(module.<name>) inside the block."""
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def phase_text_cli(smi: str) -> None:
    """The text side and the eval CLIs. (a) The VOC text bank (45 prompts,
    TSE over the shipped [512, 112] bank) at ViT-B/16's text widths from
    seeded random weights, on the card and on the CPU, in fp32 and in the
    fast preset, its build time on the card. (b) Those weights written by
    `save_params_npz` and a seeded head by `save_head_npz`; the CLIs'
    `main(argv)` on an 8-image synthetic tree in a temporary work dir:
    infer_lam --training-free --crf-tpu in both presets, infer_lam --head
    and infer_seg --head --save-preds in the fast preset, rescore on those
    predictions. (c) Finite scores, rescore's equal to infer_seg's, every
    kernel of each CLI's path launched (counts reset just before and read
    just after each run), img/s of each sweep."""
    import shutil
    import tempfile

    from excel_tpu_torch.cli import infer_lam, infer_seg, rescore
    from excel_tpu_torch.config import asset_path, fast, voc_config
    from excel_tpu_torch.engine.checkpoint import save_head_npz
    from excel_tpu_torch.models.excel import build_text_bank
    from excel_tpu_torch.models.head import init_head_params
    from excel_tpu_torch.models.params import (init_clip_params,
                                               save_params_npz)
    from excel_tpu_torch.text.class_names import prompt_vocabulary

    card = smi.replace(", ", " ")
    clip_cpu = init_clip_params(voc_config().clip,
                                torch.Generator().manual_seed(0),
                                device="cpu")
    clip = _tree_to(clip_cpu, "cuda")
    with np.load(asset_path("attributes", "pascal_voc_bank_112.npz")) as z:
        bank = torch.from_numpy(z["cluster_bank"])
    vocab = prompt_vocabulary("pascal_voc")
    for preset in ("fp32", "fast"):
        cfg = voc_config() if preset == "fp32" else fast(voc_config())
        ms = median_wall_ms(lambda: build_text_bank(clip, cfg, vocab,
                                                    bank.cuda()))
        got = build_text_bank(clip, cfg, vocab, bank.cuda()).cpu()
        t0 = time.perf_counter()
        ref = build_text_bank(clip_cpu, cfg, vocab, bank)
        cpu_s = time.perf_counter() - t0
        err = max_err(got, ref)
        tol = (TEXT_BANK_TOL_FP32 if preset == "fp32" else
               TEXT_BANK_ULPS_FAST * 2.0 ** -7 * float(ref.abs().max()))
        norms = torch.linalg.vector_norm(got, dim=1)
        log(f"text_cli text_bank {preset}: [{len(vocab)} prompts -> "
            f"{tuple(got.shape)}] build_ms={ms:.3f} (card, median of 3 "
            f"synchronised builds; {card}) cpu_s={cpu_s:.2f} max_abs_err="
            f"{err:.3g} (bound {tol:.3g}) row norms "
            f"[{float(norms.min()):.7f}, {float(norms.max()):.7f}]")
        if not (torch.isfinite(got).all() and err <= tol
                and float((norms - 1).abs().max()) <= 1e-5):
            raise AssertionError(f"text bank {preset}: card against CPU "
                                 f"{err:.3g} > {tol:.3g}, or rows not unit")

    cfg = voc_config()
    os.makedirs(os.path.join(ROOT, "work_dirs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="text_cli_",
                            dir=os.path.join(ROOT, "work_dirs"))
    try:
        clip_npz = os.path.join(work, "clip.npz")
        head_npz = os.path.join(work, "head.npz")
        save_params_npz(clip_npz, clip_cpu)
        save_head_npz(head_npz, init_head_params(
            cfg.head, cfg.num_classes, torch.Generator().manual_seed(1),
            device="cpu"))
        del clip, clip_cpu
        flags = ["--random-init", "--synthetic", str(CLI_SAMPLES),
                 "--work-dir", work, "--clip-params", clip_npz]
        runs = [("infer_lam", "fp32", infer_lam,
                 ["--training-free", "--crf-tpu"]),
                ("infer_lam", "fast", infer_lam,
                 ["--training-free", "--crf-tpu", "--fast"]),
                ("infer_lam_head", "fast", infer_lam,
                 ["--head", head_npz, "--fast"]),
                ("infer_seg", "fast", infer_seg,
                 ["--head", head_npz, "--save-preds", "--fast"])]
        from excel_tpu_torch.engine import evaluate
        seconds, hists = [], {}

        def timing(real):
            def timed(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real(*a, **k)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                return out
            return timed

        def keeping(key):
            """Keep the confusion hist behind the scores under `key`."""
            def wrap(real):
                def scores(hist):
                    hists[key] = hist.cpu().clone()
                    return real(hist)
                return scores
            return wrap

        seg_scores = None
        for name, preset, cli, extra in runs:
            sweep = "run_msc_seg_eval" if cli is infer_seg else "run_lam_eval"
            seconds.clear()
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _patched(cli, sweep, timing), \
                    _patched(evaluate, "scores_from_hist", keeping(name)):
                out = cli.main(extra + flags)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_launches(preset, training=False)
            scores = out if isinstance(out, tuple) else (out,)
            log(f"text_cli {name} {preset}: {CLI_SAMPLES} images sweep_s="
                f"{seconds[0]:.3f} img_per_s={CLI_SAMPLES / seconds[0]:.3f} "
                f"main_s={wall:.3f} (weights file read, tree, sweep; {card}) "
                f"miou={[round(float(s['miou']), 4) for s in scores]} "
                "launches=" + json.dumps({k: v for k, v in counts.items()
                                          if v}))
            if not all(np.isfinite(s["miou"]) and np.isfinite(s["pAcc"])
                       for s in scores):
                raise AssertionError(f"text_cli {name}: non-finite scores")
            missing = [k for k in CLI_KERNELS[name, preset] if counts[k] <= 0]
            if missing:
                raise AssertionError(f"text_cli {name} {preset}: no launch "
                                     f"of {missing}")
            if cli is infer_seg:
                seg_scores = out
        with _patched(rescore, "scores_from_hist", keeping("rescore")):
            again = rescore.main(["--pred-dir", os.path.join(work, "preds"),
                                  "--fast"] + flags)
        same = torch.equal(hists["rescore"], hists["infer_seg"])
        log(f"text_cli rescore: miou={again['miou']:.6f} pAcc="
            f"{again['pAcc']:.6f} (infer_seg miou={seg_scores['miou']:.6f} "
            f"pAcc={seg_scores['pAcc']:.6f}); confusion hists equal: {same} "
            f"({int(hists['rescore'].sum())} pixels, "
            f"{int(hists['rescore'].diagonal().sum())} on the diagonal)")
        if not (same and again["miou"] == seg_scores["miou"]
                and again["pAcc"] == seg_scores["pAcc"]):
            raise AssertionError("text_cli: rescore differs from infer_seg")
    finally:
        shutil.rmtree(work, ignore_errors=True)


_ATT = "excel_tpu/models/attention_pallas.py"
_PAR = "excel_tpu/ops/par_pallas.py"
_CSRC = "excel_tpu_torch/csrc/"
# JSON name -> (source, the Pallas function it replaces): one line per
# Pallas row (rows 1-4 once per dtype; row 5 for PAR's step and for the
# CRF's message pass, fp32 and bf16); rows 4, 6 and 8 are computed by the
# kernels of rows 3, 7 and 5; launches from ROW_LAUNCHES
SOURCES = {
    "plain_attention": ("attention_plain.cu", f"{_ATT}:52"),
    "plain_attention_rows_hb": ("attention_plain.cu", f"{_ATT}:157"),
    "surgery_attention": ("attention_surgery.cu", f"{_ATT}:244"),
    "surgery_attention_rows": ("attention_surgery.cu", f"{_ATT}:295"),
    "par_diffuse": ("par_diffuse.cu", f"{_PAR}:31"),
    "par_diffuse_crf": ("par_diffuse.cu", f"{_PAR}:31"),
    "par_diffuse_crf_bf16": ("par_diffuse.cu", f"{_PAR}:31"),
    "par_diffuse_padded_hcw": ("par_diffuse.cu", f"{_PAR}:508"),
    "plain_attention_bf16": ("attention_plain.cu", f"{_ATT}:52"),
    "plain_attention_rows_hb_bf16": ("attention_plain.cu", f"{_ATT}:157"),
    "surgery_attention_bf16": ("attention_surgery.cu", f"{_ATT}:244"),
    "surgery_attention_rows_bf16": ("attention_surgery.cu", f"{_ATT}:295"),
    "par_diffuse_padded": ("par_diffuse_valid.cu", f"{_PAR}:209"),
    "par_diffuse_padded_valid": ("par_diffuse_valid.cu", f"{_PAR}:342"),
    "par_diffuse_valid_resident": ("par_diffuse_valid.cu", f"{_PAR}:654"),
    "pad_replicate_valid": ("par_pad_clamp.cu", f"{_PAR}:845"),
    "par_affinity": ("par_affinity.cu", f"{_PAR}:931"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    t0 = time.perf_counter()
    smi = phase_environment()
    phase_build()
    records = phase_kernels()
    records.update(phase_kernels_fast())
    records.update(phase_kernels_padded())
    check_fast_train_par(records)
    records.update(check_crf_diffuse())
    for preset, bound in (("fp32", MIN_LABEL_AGREEMENT),
                          ("fast", MIN_FAST_LABEL_AGREEMENT)):
        _, params, text, cfg, samples = phase_slice(preset)
        phase_profile(preset, params, text, cfg, samples)
        phase_card_vs_cpu(preset, params, text, cfg, samples, bound)
        phase_lam_crf(preset, params, text, cfg, samples)
        del params
    for preset in ("fp32", "fast"):
        cfg, params, text, samples = phase_msc(preset)
        phase_msc_card_vs_cpu(preset, cfg, params, text, samples)
        del params
    for preset, bound in (("fp32", MIN_LABEL_AGREEMENT),
                          ("fast", MIN_FAST_LABEL_AGREEMENT)):
        cfg, clip, state, text, crops = phase_train(preset)
        phase_train_card_vs_cpu(preset, cfg, clip, state, text, crops, bound)
        phase_trained_eval(preset, cfg, clip, state, text)
        del clip, state
    phase_text_cli(smi)
    table = []
    for name, (source, replaces) in SOURCES.items():
        r = records[name]
        table.append({"name": name, "route": "cuda", "source": _CSRC + source,
                      "replaces": replaces,
                      "launches": ROW_LAUNCHES.get(name, 0),
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      "library_ms": r["library_ms"]})
    log(f"total: {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
