#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (excel_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
1. environment: torch/CUDA versions, and the card's name and power limit as
   `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them;
2. build: every CUDA kernel of the port, compiled from excel_tpu_torch/csrc;
3. kernels: each kernel against its plain PyTorch version on the card at the
   main path's shapes (plus the surgery kernel at N=901), with the stated
   tolerances; CUDA-event median times of kernel, plain version and, where
   one PyTorch call computes the same function, that call;
4. the slice: `run_lam_eval` (training-free LAM eval, fp32 voc_config at full
   ViT-B/16 width, seeded random weights) over synthetic VOC-sized samples,
   with every kernel's launch count over that run checked against the
   number of batches;
5. card against CPU: one batch of 2 through `lam_eval_step` on the card and
   on the CPU (plain versions), labels compared over the valid pixels.

The line before the last is the JSON kernel table; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": <name>, "count": N}}.
It imports neither jax nor excel_tpu. It exits non-zero without a CUDA
device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the
# tensor cores and HBM3 bandwidth. The kernels of this slice are fp32 FMA.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# main-path shapes: voc_config() encoder at batch 16 and its PAR canvas
B, HEADS, N_TOK, HEAD_DIM = 16, 12, 401, 64
PAR_C, PAR_H, PAR_W = 4, 384, 512
DILATIONS = (1, 2, 4, 8, 12, 24)
# tolerances against the plain versions on the card: fp32 sums taken in
# another order (a wrong tile or a dropped key chunk is off by > 1e-3)
TOL_ATTN = 1e-4
TOL_PAR_STEP = 0.0      # same arithmetic, same order: bit for bit
TOL_PAR_CHAIN = 0.0
# share of valid pixels whose labels the card and the CPU must agree on:
# every run so far read 1.0; the 0.1% margin (the CPU slice test's bound)
# is for SVC's uint8 truncation, which can flip a box on a 1-ulp
# difference upstream
MIN_LABEL_AGREEMENT = 0.999


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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
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


def _qkv(gen, b, n):
    shape = (b, HEADS, n, HEAD_DIM)
    return [torch.randn(shape, device="cuda", generator=gen)
            for _ in range(3)]


def phase_kernels() -> dict:
    """Each kernel against its plain version at the main path's shapes.
    Returns {kernel name: record} for the JSON table."""
    import torch.nn.functional as F

    from excel_tpu_torch.models.attention_kernels import (
        fused_plain_attention, fused_surgery_attention,
        plain_attention_reference, surgery_attention_reference)
    from excel_tpu_torch.ops.par import _offsets, _replicate_valid
    from excel_tpu_torch.ops.par_kernels import (
        offsets_tensor, par_diffuse, par_diffuse_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    records = {}
    f32 = 4

    # -- plain attention: none (blocks 0-5), out (block 6), acc -----------
    q, k, v = _qkv(gen, B, N_TOK)
    acc0 = torch.rand((B, N_TOK, N_TOK), device="cuda", generator=gen)
    qkv_bytes = 4 * B * HEADS * N_TOK * HEAD_DIM * f32
    nn_bytes = B * N_TOK * N_TOK * f32
    flops = 2 * 2 * N_TOK * N_TOK * HEAD_DIM * HEADS * B
    errs = []
    for mode in ("none", "out", "acc"):
        kw = dict(need_weights=mode != "none")
        got = fused_plain_attention(
            q, k, v, acc=acc0.clone() if mode == "acc" else None, **kw)
        ref = plain_attention_reference(
            q, k, v, acc=acc0.clone() if mode == "acc" else None, **kw)
        err = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))
        errs.append(err)
        if not err <= TOL_ATTN:
            raise AssertionError(f"plain attention {mode}: max err {err}")
        acc = acc0.clone()
        kernel = time_ms(lambda: fused_plain_attention(
            q, k, v, acc=acc if mode == "acc" else None, **kw), 10)
        plain = time_ms(lambda: plain_attention_reference(
            q, k, v, acc=acc if mode == "acc" else None, **kw), 5)
        library = (time_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                           10) if mode == "none" else None)
        nbytes = qkv_bytes + {"none": 0, "out": nn_bytes,
                              "acc": 2 * nn_bytes}[mode]
        bnd, by = bound_ms(flops, nbytes)
        log(f"kernel plain_attention mode={mode} B={B} H={HEADS} N={N_TOK} "
            f"D={HEAD_DIM}: max_abs_err={err:.3g} (tol {TOL_ATTN}) "
            f"kernel_ms={kernel:.4f} plain_ms={plain:.4f} "
            f"library_ms={library} bound_ms={bnd:.4f} ({by})")
        if mode == "none":
            records["plain_attention"] = dict(
                ms=kernel, plain_ms=plain, library_ms=library, bound_ms=bnd,
                bound_by=by)
    records["plain_attention"]["max_abs_err"] = max(errs)

    # -- surgery attention: acc (blocks 7-11), out, none; N=901 with ex ----
    errs = []
    cases = [("acc", N_TOK, B, False), ("out", N_TOK, B, False),
             ("none", N_TOK, B, False), ("out", 901, 8, True),
             ("none", 901, 8, True)]
    for mode, n, b, with_ex in cases:
        q, k, v = _qkv(gen, b, n)
        acc0 = torch.rand((b, n, n), device="cuda", generator=gen)
        ex = (torch.rand((b, n, n), device="cuda", generator=gen) / n
              if with_ex else None)
        kw = dict(ex_attn=ex, need_attn=mode != "none")
        got = fused_surgery_attention(
            q, k, v, acc=acc0.clone() if mode == "acc" else None, **kw)
        ref = surgery_attention_reference(
            q, k, v, acc=acc0.clone() if mode == "acc" else None, **kw)
        err = max(max_err(g, r) for g, r in zip(got, ref))
        errs.append(err)
        if not err <= TOL_ATTN:
            raise AssertionError(f"surgery attention {mode} N={n}: "
                                 f"max err {err}")
        acc = acc0.clone()
        kernel = time_ms(lambda: fused_surgery_attention(
            q, k, v, acc=acc if mode == "acc" else None, **kw), 10)
        plain = time_ms(lambda: surgery_attention_reference(
            q, k, v, acc=acc if mode == "acc" else None, **kw), 3)
        flops = 5 * 2 * n * n * HEAD_DIM * HEADS * b
        nn = b * n * n * f32
        nbytes = (4 * b * HEADS * n * HEAD_DIM * f32 + nn
                  + {"none": 0, "out": nn, "acc": 2 * nn}[mode]
                  + (nn if with_ex else 0))
        bnd, by = bound_ms(flops, nbytes)
        log(f"kernel surgery_attention mode={mode} B={b} H={HEADS} N={n} "
            f"D={HEAD_DIM} ex={with_ex}: max_abs_err={err:.3g} "
            f"(tol {TOL_ATTN}) kernel_ms={kernel:.4f} plain_ms={plain:.4f} "
            f"library_ms=None bound_ms={bnd:.4f} ({by})")
        if mode == "acc":
            records["surgery_attention"] = dict(
                ms=kernel, plain_ms=plain, library_ms=None, bound_ms=bnd,
                bound_by=by)
    records["surgery_attention"]["max_abs_err"] = max(errs)

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
    flops = 2 * k_off * B * PAR_C * PAR_H * PAR_W
    nbytes = (B * k_off * PAR_H * PAR_W + 2 * B * PAR_C * PAR_H * PAR_W) * f32
    bnd, by = bound_ms(flops, nbytes)
    log(f"kernel par_diffuse B={B} C={PAR_C} K={k_off} {PAR_H}x{PAR_W}: "
        f"max_abs_err step={err_step:.3g} chain20={err_chain:.3g} "
        f"(tol {TOL_PAR_STEP}) kernel_ms={kernel:.4f} plain_ms={plain:.4f} "
        f"library_ms=None bound_ms={bnd:.4f} ({by})")
    records["par_diffuse"] = dict(
        ms=kernel, plain_ms=plain, library_ms=None, bound_ms=bnd,
        bound_by=by, max_abs_err=max(err_step, err_chain))
    return records


# VOC-typical label extents (h, w): landscape and portrait images
VOC_EXTENTS = [(375, 500), (333, 500), (500, 375), (375, 500), (366, 500),
               (500, 333), (375, 500), (353, 500)]


def synthetic_samples(n: int, num_fg: int, seed: int) -> list[dict]:
    """Seeded VOC-sized eval samples: textured background with 1-3 coloured
    elliptical blobs of 1-3 classes, exact labels, image-level labels."""
    rng = np.random.default_rng(seed)
    palette = rng.integers(100, 256, (num_fg + 1, 3))
    samples = []
    for i in range(n):
        h, w = VOC_EXTENTS[i % len(VOC_EXTENTS)]
        image = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
        label = np.zeros((h, w), np.int32)
        classes = rng.choice(np.arange(1, num_fg + 1),
                             size=int(rng.integers(1, 4)), replace=False)
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
    from excel_tpu_torch.ops.par_kernels import par_diffuse
    return {"plain_attention": fused_plain_attention,
            "surgery_attention": fused_surgery_attention,
            "par_diffuse": par_diffuse}


# launches of each kernel per batch of the main path: blocks 0-6 (plain),
# blocks 7-11 (surgery), 20 PAR steps
LAUNCHES_PER_BATCH = {"plain_attention": 7, "surgery_attention": 5,
                      "par_diffuse": 20}


def phase_slice(n_samples: int = 32, batch: int = 16):
    """run_lam_eval at full voc_config() width; returns (launch counts,
    params, text bank, cfg, samples)."""
    from excel_tpu_torch.config import voc_config
    from excel_tpu_torch.engine.evaluate import _bucketed_batches, run_lam_eval
    from excel_tpu_torch.models.params import init_clip_params

    cfg = voc_config()
    params = {"clip": init_clip_params(
        cfg.clip, torch.Generator().manual_seed(0), device="cuda")}
    text = text_bank(cfg, seed=0).cuda()
    samples = synthetic_samples(n_samples, cfg.num_fg, seed=0)
    n_batches = sum(1 for _ in _bucketed_batches(
        samples, batch, cfg.data.eval_pad, cfg.refine.slot_buckets,
        cfg.num_fg))
    # warm-up (cuBLAS handles, allocator) on a part of the data
    run_lam_eval(params, samples[:batch], text, cfg, batch_size=batch,
                 device="cuda")
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = run_lam_eval(params, samples, text, cfg, batch_size=batch,
                          device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers.items()}
    log(f"slice: run_lam_eval voc_config fp32 ViT-B/16 N={cfg.clip.tokens} "
        f"samples={n_samples} batch={batch} batches={n_batches} "
        f"seconds={dt:.3f} img_per_s={n_samples / dt:.3f} "
        f"(padded slots {n_batches * batch}) miou={scores['miou']:.4f} "
        f"pAcc={scores['pAcc']:.4f}")
    log("slice launches: " + json.dumps(counts))
    for name, per_batch in LAUNCHES_PER_BATCH.items():
        if counts[name] != per_batch * n_batches:
            raise AssertionError(
                f"{name}: {counts[name]} launches, expected {per_batch} x "
                f"{n_batches} batches")
    if not (0.0 <= scores["miou"] <= 1.0 and np.isfinite(scores["pAcc"])):
        raise AssertionError(f"bad scores {scores['miou']} {scores['pAcc']}")
    return counts, params, text, cfg, samples


def phase_profile(params, text, cfg, samples, batch: int = 16) -> None:
    """Device time by kernel over one main-path batch (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

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

    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls[1:])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    log(f"profile: one batch of {batch} canvas={canvas} slots={slots} "
        f"wall_ms={wall:.2f} (median of 3, profiler off) device_ms="
        f"{device_us / 1e3:.2f} (profiled run) busy_share="
        f"{device_us / 1e3 / wall:.3f} host_prep_ms={prep_ms:.2f} "
        f"(_prep_batch: numpy resize of the batch's images)")
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    for e in top:
        log(f"profile: {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<5d} {e.key[:90]}")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def phase_card_vs_cpu(params, text, cfg, samples) -> float:
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
    log(f"card_vs_cpu: batch=2 canvas={canvas} slots={slots} valid_pixels="
        f"{int(mask.sum())} label_agreement={agree:.6f} (bound "
        f">= {MIN_LABEL_AGREEMENT}) card_s={t1 - t0:.2f} cpu_s={t2 - t1:.2f}")
    if not agree >= MIN_LABEL_AGREEMENT:
        raise AssertionError(f"card and CPU labels agree on {agree:.4f} of "
                             f"the valid pixels")
    return agree


SOURCES = {
    "plain_attention": ("excel_tpu_torch/csrc/attention_plain.cu",
                        "excel_tpu/models/attention_pallas.py:52"),
    "surgery_attention": ("excel_tpu_torch/csrc/attention_surgery.cu",
                          "excel_tpu/models/attention_pallas.py:244"),
    "par_diffuse": ("excel_tpu_torch/csrc/par_diffuse.cu",
                    "excel_tpu/ops/par_pallas.py:31"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    t0 = time.perf_counter()
    phase_environment()
    phase_build()
    records = phase_kernels()
    counts, params, text, cfg, samples = phase_slice()
    phase_profile(params, text, cfg, samples)
    phase_card_vs_cpu(params, text, cfg, samples)
    table = []
    for name, (source, replaces) in SOURCES.items():
        r = records[name]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": counts[name],
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
