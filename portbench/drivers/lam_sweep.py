"""lam_sweep: the training-free pseudo-label sweep.

Drives `engine/evaluate.run_lam_eval(mode="training_free")`, the main
path, over an endless stream read through the program's dataset readers
from the pool's tree, for the window's seconds. Set-up: the pool and its
tree, the weights and text bank on the device, and a warm-up sweep over one
batch of every canvas and class-slot group the stream takes (the kernels
build there on a checkout's first run). The window ends at the first batch
past its seconds, then the device is synchronised: the device's busy time
over the images of every batch it enqueued (the end-to-end metric), and
those images over the window's wall (per layer).

The check runs the plain float32 reference (reference/pipeline.lam_image)
from each raw image the window served (its first time through) and
compares the program's LAMs, its block-mean attention and its labels,
these also against the reference's SVC and PAR run from the program's own
LAMs and attention.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.harness import flops as F
from portbench.harness import sweep as S
from portbench.harness import traffic as T
from portbench.harness import weights as W
from portbench.harness.context import Outcome, compared
from portbench.harness.hooks import attention_work, par_work
from portbench.reference import pipeline as R
from portbench.reference.precision import Precision, exact_matmuls


def model_inputs(ctx):
    cfg, spec = ctx.cfg, ctx.spec
    params = {"clip": W.clip_visual(cfg.clip, ctx.seed, ctx.device)}
    text = W.text_bank(cfg.num_fg + spec["background_rows"],
                       cfg.clip.embed_dim, ctx.seed, ctx.device)
    return params, text


def reference_numbers(cfg, params, text) -> dict:
    return {"visual": params["clip"]["visual"], "text": text,
            "size": cfg.clip.image_size, "patch": cfg.clip.patch_size,
            "heads": cfg.clip.vision_heads,
            "surgery": cfg.clip.surgery_blocks,
            "window": cfg.clip.attn_out_layers, "num_fg": cfg.num_fg,
            "caa": cfg.refine.caa_threshold,
            "dilations": tuple(cfg.refine.par_dilations),
            "iters": cfg.refine.par_iters}


def run(ctx) -> Outcome:
    from excel_tpu_torch.cli.common import exact_matmuls as program_matmuls
    from excel_tpu_torch.engine import evaluate
    from excel_tpu_torch.models import clip as clip_mod

    cfg, mix, spans = ctx.cfg, ctx.traffic, ctx.spans
    batch, mode = mix["batch_size"], mix["mode"]
    program_matmuls()
    pool = T.make_pool(mix, cfg.num_fg, ctx.seed)
    ds = S.dataset(ctx, pool)
    params, text = model_inputs(ctx)
    warm = S.warm_samples(ds, batch, cfg.data.eval_pad,
                          cfg.refine.slot_buckets, cfg.num_fg)
    evaluate.run_lam_eval(params, warm, text, cfg, mode=mode,
                          batch_size=batch, device=ctx.device)

    cap = S.Capture(pool)
    work = {"flops": 0.0, "attn_bound_s": 0.0, "par_bound_s": 0.0}
    hw = cfg.clip.grid ** 2
    rows = text.shape[0]
    per_image = (F.encoder_flops(cfg.clip, cfg.clip.image_size)
                 + F.surgery_lam_flops(cfg.clip, cfg.clip.image_size, rows))

    def step_before(args, kwargs):
        cap.next_batch()
        if spans.tracing:
            b = args[2].shape[0]
            slots = kwargs.get("class_slots") or cfg.num_fg
            work["flops"] += b * (per_image + F.svc_flops(hw, slots))

    stream = S.Stream(ds, spans, ctx.seed)
    spans.wrap(evaluate, "_prep_batch", "prep",
               before=lambda a, k: cap.prepared(a[0]))
    spans.wrap(evaluate, "lam_eval_hist_step", "step", before=step_before)
    spans.wrap(evaluate, "_to_device", "to_device")
    spans.wrap_iter(evaluate, "prefetch_iter", "wait")
    spans.wrap(evaluate, "encode_image", "encoder",
               after=lambda out, a, k: cap.pending and
               cap.take("attn", out["attn"]))
    spans.wrap(evaluate, "compute_lams", "lams",
               after=lambda out, a, k: cap.pending and cap.take("lams", out))
    spans.wrap(evaluate, "update_hist", "hist",
               before=lambda a, k: cap.pending and
               cap.take("labels", a[2], crop=True, dtype=torch.uint8))
    spans.wrap(evaluate, "par_refine", "par", before=par_work(ctx, work))
    hook = attention_work(ctx, work)
    spans.wrap(clip_mod, "attention_fused", "attn", before=hook("plain"))
    spans.wrap(clip_mod, "surgery_attention_fused", "attn",
               before=hook("surgery"))

    setup_s, window_s, images, win = S.timed_sweep(
        ctx, lambda progress: evaluate.run_lam_eval(
            params, stream, text, cfg, mode=mode, batch_size=batch,
            progress=progress, device=ctx.device))
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    checks, info = check(ctx, pool, cap, reference_numbers(cfg, params,
                                                           text))
    info["batches"] = cap.batch + 1
    info["batches_per_second"] = win.per_second()
    info["host"] = win.host
    info["img_per_s"] = images / window_s
    work["images"] = images
    return Outcome(setup_s=setup_s, window_s=window_s,
                   attempted=images, failed=0,
                   e2e={"lam_device_ms_per_img": win.device_ms_per(images),
                        "setup_s": setup_s},
                   checks=checks, memory_peak_bytes=peak, work=work,
                   info=info)


def check(ctx, pool, cap, m):
    """The numbers, each compared with its limit where the cell's limits
    file names it: the outputs missing (always, exactly 0); over every pool
    image the window served, the largest LAM
    gap, the largest attention gap (as a share of the attention's largest
    value), the median over the images of the share of pixels whose label
    differs from the reference's, and the label misses: the largest share,
    over the images, of the pixels whose label's map lies more than
    reference/pipeline.MISS_GAP below the best map there, the maps made by
    the reference's SVC and PAR from the LAMs and attention that the
    program's SVC took. The last covers SVC, PAR and the labels image by
    image, so in every slot bucket; it starts from the program's LAMs
    because a box of SVC that rounding flips between the bfloat16 program
    and the reference moves a block of one image's labels (PERF.md), and
    the LAMs and attention themselves are held to the reference by lam_err
    and attn_err. Reported: the pooled share of differing labels, and the
    label gaps' summaries (reference/pipeline.gap_summary) over all images
    and among the images of each class count."""
    exact_matmuls()
    dev = ctx.device
    control = Precision(ctx.control) if ctx.control else None
    lam_err = attn_err = 0.0
    differ = total = 0
    shares, gaps, by_count = [], {}, {}
    lost = S.missing(cap, ("lams", "attn", "labels"))
    with torch.no_grad():
        for i in sorted(cap.out):
            got = cap.out[i]
            if len(got) < 3:
                continue
            raw = torch.from_numpy(pool[i]["image"]).to(dev)
            cls = torch.from_numpy(pool[i]["cls_label"]).to(dev)
            ref = R.lam_image(m, raw, cls)
            if control is not None:
                got = R.lam_image(m, raw, cls, prec=control)
            lam_err = max(lam_err, float((got["lams"].float()
                                          - ref["lams"]).abs().max()))
            attn_err = max(attn_err, float(
                (got["attn"].float() - ref["attn"]).abs().max()
                / ref["attn"].abs().max()))
            present = torch.nonzero(cls > 0).flatten()
            cams = R.cams_from_state(m, got["lams"][:, present].t(),
                                     got["attn"][1:, 1:], ref["guide"])
            gap = R.gap_summary(R.label_gap(cams, present, got["labels"]))
            for stats in (gaps, by_count.setdefault(len(present), {})):
                for key, v in gap.items():
                    stats[key] = max(stats.get(key, 0.0), v)
            d = int((got["labels"].long() != ref["labels"]).sum())
            shares.append(d / ref["labels"].numel())
            differ += d
            total += ref["labels"].numel()
    if not cap.out:
        raise RuntimeError("the window served no image to compare")
    numbers = {"lam_err": lam_err, "attn_err": attn_err,
               "label_mismatch_median": float(np.median(shares)),
               "label_miss": gaps["miss"]}
    checks = [("missing_outputs", lost, 0)] + compared(numbers, ctx.limits)
    return checks, {"numbers": numbers,
                    "label_mismatch": differ / max(total, 1),
                    "label_mismatch_max": max(shares),
                    "label_gaps": gaps,
                    "label_gaps_by_classes": {str(k): by_count[k]
                                              for k in sorted(by_count)},
                    "images_compared": sum(1 for g in cap.out.values()
                                           if len(g) == 3)}
