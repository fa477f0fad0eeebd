"""train: the LVC head's training loop.

Runs the per-step work of cli/train._train_loop without validation or
checkpoints: `data/loader.train_batches` at the CLI's default worker count
over `data/datasets.ClsCropDataset` (the pool's tree), the phase of the
step (`engine/train._phase`), its `TrainStepCache` step with the dropout
generator of the step, the device-side sums of the losses and their
readback every `log_iters`. The window's i-th step runs global step
(i x stride) mod max_iters, the stride near max_iters over the golden
ratio, so that however many steps the window holds, they take the three
phases in the schedule's proportion.

Set-up builds one train state (the seeded head in the program's LvcHead
and its AdamW), drives it through the traffic's check steps (the first in
the seg-affinity phase, so calibrated, from the seeded head; then two
uncalibrated ones at learning rates that move the head) and then through
warm-up steps (the calibrated phase alone, then on until both class-slot
buckets have run), and hands the same state to the window. The reference
follows the check steps from the same initial head on crops it makes
itself (reference/augment.py): the first step's LAMs, SVC attention and
pseudo-labels, each step's loss, the first gradient (from the optimizer's
first moment after one step) and the head's change after the check steps,
leaf by leaf.

A step's time runs from the previous step's CUDA event to its own, each
recorded after the optimizer's step and read after the window; they add
up to the window.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import statistics
import time

import numpy as np
import torch

from portbench.drivers.lam_sweep import model_inputs
from portbench.drivers.msc import make_head
from portbench.harness import flops as F
from portbench.harness import traffic as T
from portbench.harness import weights as W
from portbench.harness.context import Outcome, Window, compared
from portbench.harness.hooks import par_work
from portbench.harness.seeds import sub_seed
from portbench.reference import augment
from portbench.reference import pipeline as RP
from portbench.reference import svc as RS
from portbench.reference import train as RT
from portbench.reference.precision import Precision, exact_matmuls

DEVICE_METRICS = ("seg_loss", "diver_loss")
WARM_CAP = 30


class Clock:
    """Step ends: CUDA events on the card (read after the window), the
    host clock elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self):
        m = self.marks
        if self.cuda:
            return [m[k - 1].elapsed_time(m[k]) for k in range(1, len(m))]
        return [1e3 * (m[k] - m[k - 1]) for k in range(1, len(m))]


def step_work(cfg, text_rows, b, calibrated, slots):
    """Matrix-product FLOPs of one train step: the encoder pass (two when
    calibrated), feature surgery, the head's forward and backward (2x),
    the feature gram and, calibrated, the calibration's similarity; SVC."""
    size = cfg.data.crop_size
    tokens = (size // cfg.clip.patch_size) ** 2
    d = cfg.head.embedding_dim
    enc = F.encoder_flops(cfg.clip, size) + F.surgery_lam_flops(
        cfg.clip, size, text_rows)
    per = enc * (2 if calibrated else 1)
    per += 3 * F.head_flops(cfg.head, tokens, cfg.num_classes)
    per += 2.0 * tokens * tokens * d * (2 if calibrated else 1)
    per += F.svc_flops(tokens, slots)
    return b * per


def run(ctx) -> Outcome:
    from excel_tpu_torch.cli.common import exact_matmuls as program_matmuls
    from excel_tpu_torch.data import datasets, loader
    from excel_tpu_torch.engine import pipeline
    from excel_tpu_torch.engine import train as E
    from excel_tpu_torch.engine.evaluate import _to_device

    mix, spans, dev = ctx.traffic, ctx.spans, ctx.device
    cfg = dataclasses.replace(ctx.cfg, train=dataclasses.replace(
        ctx.cfg.train, seed=sub_seed(ctx.seed, "train", 31)))
    batch = cfg.train.batch_size
    program_matmuls()
    pool = T.make_pool(mix, cfg.num_fg, ctx.seed)
    split_dir = T.write_tree(pool, mix, ctx.workdir)
    base = datasets.VocDataset(ctx.workdir, split_dir, mix["split"], "train")
    base.num_fg = cfg.num_fg
    ds = datasets.ClsCropDataset(base, crop_size=cfg.data.crop_size,
                                 rescale_range=tuple(cfg.data.rescale_range),
                                 ignore_index=cfg.data.ignore_index)
    params, text = model_inputs(ctx)
    clip = params["clip"]
    init = W.head_state(cfg.head, cfg.num_classes, ctx.seed, dev)
    head = make_head(cfg, init, dev)
    state = E.init_train_state(head, cfg.train)
    workers = min(10, os.cpu_count() or 1)
    batches = loader.train_batches(ds, batch, seed=cfg.train.seed,
                                   num_workers=workers)
    steps = E.TrainStepCache(cfg)
    work = {"flops": 0.0, "par_bound_s": 0.0}
    next_batch = spans.timed("loader_wait", lambda: next(batches))
    first_crops = []

    def one_step(g):
        b = next_batch()
        if len(first_crops) < len(mix["check_steps"]):
            first_crops.append(b["image"].copy())
        phase = E._phase(cfg, g)
        fn = steps(phase, b["cls_label"])
        if spans.tracing:
            slots = steps.slots_for(b["cls_label"]) or cfg.num_fg
            work["flops"] += step_work(cfg, text.shape[0], batch, phase[0],
                                       slots)
        images, cls = _to_device((b["image"], b["cls_label"]), dev)
        state.step = g
        _, metrics = fn(state, clip, images, cls, text,
                        E.step_generator(cfg.train, g, dev))
        return metrics, steps.slots_for(b["cls_label"])

    first = {}

    def keep_state(out, args, kwargs):
        """The first step's pseudo-labels and what SVC made them from."""
        if not first:
            seg = kwargs.get("seg_attn")
            first.update(pseudos=out.clone(), lams=args[0].detach().clone(),
                         attn=args[1].detach().clone(),
                         seg_attn=None if seg is None else seg.clone())

    if ctx.fault == "half_batch":
        spans.replace(E, "train_losses", half_batch)
    elif ctx.fault == "altered":
        spans.replace(E, "pseudo_labels", altered)
    spans.wrap(pipeline, "par_refine", "par", before=par_work(ctx, work))
    spans.wrap(E, "train_step", "step")
    spans.wrap(E, "train_losses", "losses")
    spans.wrap(E, "pseudo_labels", "pseudo", after=keep_state)
    names = [n for n, _ in head.named_parameters()]
    beta1 = cfg.train.betas[0]
    try:
        losses, seen = [], set()
        for j, g in enumerate(mix["check_steps"]):
            metrics, slots = one_step(g)
            losses.append(metrics["loss"])
            seen.add(slots)
            if j == 0:
                grad1 = {n: state.optimizer.state[p].get(
                    "exp_avg", torch.zeros_like(p)).detach().clone()
                    / (1 - beta1) for n, p in head.named_parameters()}
        after = {n: p.detach().clone() for n, p in head.named_parameters()}
        losses = [float(x) for x in losses]
        warm = mix["warm_steps"]
        for j in range(WARM_CAP):
            if j >= len(warm) and set(steps.buckets) <= seen:
                break
            _, slots = one_step(warm[j % len(warm)] + j)
            seen.add(slots)
        ctx.synchronize()

        stride, t_max = mix["stride"], cfg.train.max_iters
        clock = Clock(dev)
        win = Window(ctx)
        sums, count, n = {}, 0, 0
        setup_s = time.perf_counter() - ctx.t_process
        win.open()
        clock.mark()
        while True:
            metrics, _ = one_step((n * stride) % t_max)
            n += 1
            for k in DEVICE_METRICS:
                v = metrics[k].double()
                sums[k] = v if k not in sums else sums[k] + v
            count += 1
            if count % cfg.train.log_iters == 0:
                torch.stack([sums[k] for k in DEVICE_METRICS]).cpu()
                sums.clear()
            clock.mark()
            if win.tick():
                break
        window_s = win.close()
    finally:
        spans.restore()
        batches.close()
    times = clock.intervals_ms()
    peak = (torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else 0)
    checks, info = check(ctx, cfg, pool, init, losses, grad1, after, clip,
                         text, names, first_crops, first)
    info.update(steps=n, step_ms_median=statistics.median(times),
                step_ms_p95=float(np.percentile(times, 95)),
                steps_per_second=win.per_second(), host=win.host,
                warm_steps=len(mix["check_steps"]) + j)
    info["img_per_s"] = n * batch / window_s
    work["images"] = n * batch
    return Outcome(setup_s=setup_s, window_s=window_s, attempted=n,
                   failed=0,
                   e2e={"train_device_ms_per_img":
                        win.device_ms_per(n * batch),
                        "setup_s": setup_s},
                   checks=checks, memory_peak_bytes=peak, work=work,
                   info=info)


def half_batch(full):
    """The fault of a step that leaves out half of its batch and takes its
    means over the rest (for the check's readings)."""
    def half(head, clip, images, cls, *a, **k):
        h = images.shape[0] // 2
        return full(head, clip, images[:h], cls[:h], *a, **k)
    return half


def altered(full):
    """The fault of a step whose pseudo-labels are altered where they are
    made: every image's top quarter takes the next class id (for the
    check's readings)."""
    def alter(*a, **k):
        out = full(*a, **k)
        q = out.shape[1] // 4
        return torch.cat([out[:, :q] + 1, out[:, q:]], dim=1)
    return alter


def reference_numbers(cfg, clip, text) -> dict:
    t = cfg.train
    return {"visual": clip["visual"], "text": text,
            "patch": cfg.clip.patch_size, "heads": cfg.clip.vision_heads,
            "surgery": cfg.clip.surgery_blocks,
            "window": cfg.clip.attn_out_layers, "num_fg": cfg.num_fg,
            "caa": cfg.refine.caa_threshold,
            "attn_layers": cfg.refine.attn_layers,
            "dilations": tuple(cfg.refine.par_dilations),
            "iters": cfg.refine.par_iters, "radius": cfg.refine.radius,
            "embed": cfg.head.embedding_dim, "dropout": cfg.head.dropout,
            "head_blocks": cfg.head.num_blocks,
            "head_layers": cfg.head.decoder_layers,
            "head_heads": cfg.head.decoder_heads,
            "train": {"lr": t.lr, "warmup_iters": t.warmup_iters,
                      "max_iters": t.max_iters, "power": t.power,
                      "warmup_ratio": t.warmup_ratio, "seed": t.seed,
                      "lvc_calibrate_iter": t.lvc_calibrate_iter,
                      "seg_affinity_iter": t.seg_affinity_iter,
                      "w_seg": t.w_seg, "w_diver": t.w_diver,
                      "betas": tuple(t.betas),
                      "weight_decay": t.weight_decay}}


def _norm(x):
    return float(x.float().norm())


def program_state(m, first) -> dict:
    """The program's first step as the reference's step gives it: its
    pseudo-labels, the LAMs SVC took and the attention that drove SVC,
    aggregated from the program's per-block stack and decoder affinity
    by the reference's own rule where the step is calibrated."""
    attn = first["attn"]
    if attn.dim() == 3:                   # the blocks' mean [B, N, N]
        agg = attn[:, 1:, 1:].float()
    else:                                 # the stack [L, B, N, N]
        stack = attn[-m["attn_layers"]:, :, 1:, 1:].float()
        agg = torch.stack([
            RS.aggregate_attn(stack[:, i], first["seg_attn"][i].float())
            for i in range(stack.shape[1])])
    return {"pseudos": first["pseudos"], "lams": first["lams"].float(),
            "attn": agg}


def pseudo_gaps(m, state, images, cls) -> list:
    """Each first-step image's label gaps (reference/pipeline.gap_summary):
    how far the map of its pseudo-label lies below the best map, the maps
    made by the reference's SVC and PAR from the LAMs and attention that
    the step's own SVC took (so a box that rounding flips upstream does
    not count here: the LAMs and attention are held to the reference by
    lam_err and attn_err), with PAR's guide from the reference's own
    crops."""
    guide = RT.denormalize(images).permute(0, 3, 1, 2)
    gaps = []
    for i in range(len(state["pseudos"])):
        present = torch.nonzero(cls[i] > 0).flatten()
        cams = RP.cams_from_state(m, state["lams"][i][:, present].t(),
                                  state["attn"][i], guide[i])
        gaps.append(RP.gap_summary(RP.label_gap(cams, present,
                                                state["pseudos"][i])))
    return gaps


def check(ctx, cfg, pool, init, losses, grad1, after, clip, text, names,
          first_crops, first):
    """The numbers, each compared where the cell's limits file names it:
    the first check step's LAMs (the calibrated pass's where the step is
    calibrated) by the worst image's norm of the difference over the
    reference's norm (a batch cut short reads 1; the largest single gap,
    which the calibration's sharpened attention lets one rounding swing,
    is reported as lam_err); the attention that drove its SVC (largest gap
    over the reference's largest value); its pseudo-labels by their
    misses, the median over the batch's images of the share of pixels
    whose label gap in `pseudo_gaps` passes reference/pipeline.MISS_GAP
    (one image of a sound bfloat16 run can read 29%, PERF.md); and, by the
    worst leaf, the gap of the change's norm after the check steps against
    the larger of the reference's norm of that leaf and of the median leaf
    (leaves whose reference gradient is under a thousandth of the median
    leaf's take no part). Reported (PERF.md gives their readings): the
    largest image's misses, each step's loss gap, the first gradient's
    norm gap by the worst leaf, the share of the first step's
    pseudo-labels that differ from the reference's own."""
    exact_matmuls()
    dev = ctx.device
    mix = ctx.traffic
    m = reference_numbers(cfg, clip, text)
    k = len(mix["check_steps"])
    crops = list(itertools.islice(augment.batches(
        pool, cfg.train.batch_size, cfg.train.seed, cfg.data.crop_size,
        tuple(cfg.data.rescale_range)), k))
    crop_diff = sum(int((a != b[0]).sum()) for a, b in zip(first_crops,
                                                           crops))
    batches = [(torch.from_numpy(im).to(dev), torch.from_numpy(c).to(dev))
               for im, c in crops]
    ref = RT.run_steps(m, init, batches, mix["check_steps"])
    if ctx.control:
        got = RT.run_steps(m, init, batches, mix["check_steps"],
                           prec=Precision(ctx.control))
        losses, grad1, after = got["losses"], got["grads"], got["params"]
        state = got["first"]
    else:
        state = program_state(m, first)
    rf = ref["first"]
    whole = state["lams"].shape == rf["lams"].shape
    lam_err = float((state["lams"] - rf["lams"]).abs().max()) \
        if whole else 1.0
    lam_rel = max(float((a - b).norm() / b.norm()) for a, b in zip(
        state["lams"], rf["lams"])) if whole else 1.0
    attn_err = float((state["attn"] - rf["attn"]).abs().max()
                     / rf["attn"].abs().max()) if whole else 1.0
    gaps = pseudo_gaps(m, state, *batches[0])
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    # pseudo-labels of a batch cut short count as all differing
    pseudo_mismatch = float(
        (state["pseudos"].long() != rf["pseudos"]).float().mean()) \
        if state["pseudos"].shape == rf["pseudos"].shape else 1.0
    gn_ref = {n: _norm(ref["grads"][n]) for n in names}
    med_g = statistics.median(gn_ref.values())
    g_gap = {n: abs(_norm(grad1[n]) - gn_ref[n]) / max(gn_ref[n], med_g)
             for n in names}
    moved = [n for n in names if gn_ref[n] >= 1e-3 * med_g]
    dn_ref = {n: _norm(ref["params"][n] - init[n]) for n in moved}
    med_d = statistics.median(dn_ref.values())
    u_gap = {n: abs(_norm(after[n] - init[n]) - dn_ref[n])
             / max(dn_ref[n], med_d) for n in moved}
    numbers = {"lam_rel": lam_rel, "attn_err": attn_err,
               "pseudo_miss": statistics.median(g["miss"] for g in gaps),
               "update_err": max(u_gap.values())}
    return compared(numbers, ctx.limits), {
                    "numbers": numbers, "lam_err": lam_err,
                    "pseudo_miss_max": max(g["miss"] for g in gaps),
                    "losses": losses, "ref_losses": ref["losses"],
                    "loss_gaps": loss_gaps,
                    "grad_err": max(g_gap.values()),
                    "pseudo_gaps": gaps,
                    "pseudo_mismatch": pseudo_mismatch,
                    "grad_worst": max(g_gap, key=g_gap.get),
                    "grad_median_gap": statistics.median(g_gap.values()),
                    "update_worst": max(u_gap, key=u_gap.get),
                    "update_median_gap": statistics.median(u_gap.values()),
                    "crop_pixels_differing": crop_diff,
                    "leaves_moved": len(moved), "leaves": len(names)}
