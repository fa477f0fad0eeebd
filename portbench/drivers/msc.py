"""msc: the final segmentation eval, MSC + flip.

Drives `engine/evaluate.run_msc_seg_eval` (scales and batch from the
traffic file, no CRF) with a seeded LVC head over an endless stream read
through the program's dataset readers, for the window's seconds; set-up
and the window's end as in drivers/lam_sweep.py (a warm-up sweep over one
batch of every canvas the stream takes).

The check runs the plain float32 reference (reference/pipeline.msc_image)
from each raw image the window served (its first time through) and
compares the logits summed over the scales at seeded pixels of each.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.drivers.lam_sweep import model_inputs
from portbench.harness import flops as F
from portbench.harness import sweep as S
from portbench.harness import traffic as T
from portbench.harness import weights as W
from portbench.harness.context import Outcome
from portbench.harness.hooks import attention_work
from portbench.harness.seeds import sub_seed
from portbench.reference import pipeline as R
from portbench.reference.precision import Precision, exact_matmuls

PIXELS = 4096      # logits compared per image, at seeded positions


def make_head(cfg, state, device):
    """The program's LvcHead holding the benchmark's seeded values."""
    from excel_tpu_torch.models.head import LvcHead

    head = LvcHead(cfg.head, cfg.num_classes)
    head.load_state_dict({k: v.cpu() for k, v in state.items()})
    return head.to(device)


def run(ctx) -> Outcome:
    from excel_tpu_torch.cli.common import exact_matmuls as program_matmuls
    from excel_tpu_torch.engine import evaluate
    from excel_tpu_torch.models import clip as clip_mod

    cfg, mix, spans = ctx.cfg, ctx.traffic, ctx.spans
    batch, scales = mix["batch_size"], tuple(mix["scales"])
    program_matmuls()
    pool = T.make_pool(mix, cfg.num_fg, ctx.seed)
    ds = S.dataset(ctx, pool)
    params, text = model_inputs(ctx)
    state = W.head_state(cfg.head, cfg.num_classes, ctx.seed, ctx.device)
    params["head"] = make_head(cfg, state, ctx.device)
    warm = S.warm_samples(ds, batch, cfg.data.eval_pad, None, cfg.num_fg)
    evaluate.run_msc_seg_eval(params, warm, text, cfg, scales=scales,
                              batch_size=batch, device=ctx.device)

    cap = S.Capture(pool)
    rng = np.random.default_rng(sub_seed(ctx.seed, "pixels"))
    pixels = [torch.from_numpy(rng.integers(0, h * w, min(PIXELS, h * w)))
              .to(ctx.device) for h, w in cap.hw]
    work = {"flops": 0.0, "attn_bound_s": 0.0}
    base = cfg.clip.image_size
    per_image = 0.0
    for sc in scales:
        size = int(base * sc)
        passes = 1 if sc == 1.0 else 2
        tokens = (size // cfg.clip.patch_size) ** 2
        per_image += passes * (
            F.encoder_flops(cfg.clip, size)
            + F.surgery_lam_flops(cfg.clip, size, text.shape[0])
            + F.head_flops(cfg.head, tokens, cfg.num_classes))

    def step_before(args, kwargs):
        cap.next_batch()
        if spans.tracing:
            work["flops"] += args[2][0].shape[0] * per_image

    def argmax_before(args, kwargs):
        if cap.pending:
            cap.take("logits", args[0], crop=True,
                     pick=lambda i, t: t.reshape(t.shape[0], -1)[:, pixels[i]])

    stream = S.Stream(ds, spans, ctx.seed)
    spans.wrap(evaluate, "_prep_msc_batch", "prep_msc",
               before=lambda a, k: cap.prepared(a[0]))
    spans.wrap(evaluate, "msc_hist_step", "step", before=step_before)
    spans.wrap(evaluate, "_to_device", "to_device")
    spans.wrap_iter(evaluate, "prefetch_iter", "wait")
    spans.wrap(evaluate, "canvas_argmax", "argmax", before=argmax_before,
               after=lambda out, a, k: cap.pending and
               cap.take("labels", out, crop=True, dtype=torch.uint8))
    hook = attention_work(ctx, work)
    spans.wrap(clip_mod, "attention_fused", "attn", before=hook("plain"))
    spans.wrap(clip_mod, "surgery_attention_fused", "attn",
               before=hook("surgery"))

    setup_s, window_s, images, win = S.timed_sweep(
        ctx, lambda progress: evaluate.run_msc_seg_eval(
            params, stream, text, cfg, scales=scales, batch_size=batch,
            progress=progress, device=ctx.device))
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    m = {"visual": params["clip"]["visual"], "text": text, "head": state,
         "size": base, "scales": scales, "patch": cfg.clip.patch_size,
         "heads": cfg.clip.vision_heads, "surgery": cfg.clip.surgery_blocks,
         "window": cfg.clip.attn_out_layers,
         "head_blocks": cfg.head.num_blocks,
         "head_layers": cfg.head.decoder_layers,
         "head_heads": cfg.head.decoder_heads}
    checks, info = check(ctx, pool, cap, m, pixels)
    info["batches"] = cap.batch + 1
    info["batches_per_second"] = win.per_second()
    info["host"] = win.host
    info["img_per_s"] = images / window_s
    work["images"] = images
    return Outcome(setup_s=setup_s, window_s=window_s,
                   attempted=images, failed=0,
                   e2e={"msc_device_ms_per_img": win.device_ms_per(images),
                        "setup_s": setup_s},
                   checks=checks, memory_peak_bytes=peak, work=work,
                   info=info)


def check(ctx, pool, cap, m, pixels):
    """Compared: the outputs missing (exactly 0); over every pool image the
    window served, the largest gap of the logits summed over the scales,
    at the image's seeded pixels, as a share of their largest magnitude.
    Reported: the share of pixels whose label differs (its float8 control
    reads 0 on some seeds, where a random head's argmax is one class)."""
    exact_matmuls()
    dev = ctx.device
    control = Precision(ctx.control) if ctx.control else None
    logit_err = 0.0
    differ = total = n_logits = 0
    shares = []
    lost = S.missing(cap, ("labels", "logits"))
    with torch.no_grad():
        for i in sorted(cap.out):
            got = cap.out[i]
            if "labels" not in got:
                continue
            raw = torch.from_numpy(pool[i]["image"]).to(dev)
            ref = R.msc_image(m, raw)
            ref_px = ref["logits"].reshape(ref["logits"].shape[0],
                                           -1)[:, pixels[i]]
            if control is not None:
                ctl = R.msc_image(m, raw, prec=control)
                got = {"labels": ctl["labels"], "logits": ctl["logits"]
                       .reshape(ref_px.shape[0], -1)[:, pixels[i]]}
            if "logits" in got:
                n_logits += 1
                logit_err = max(logit_err, float(
                    (got["logits"].float() - ref_px).abs().max()
                    / ref_px.abs().max()))
            d = int((got["labels"].long() != ref["labels"]).sum())
            shares.append(d / ref["labels"].numel())
            differ += d
            total += ref["labels"].numel()
    total = max(total, 1)
    if not cap.out:
        raise RuntimeError("the window served no image to compare")
    lim = ctx.limits
    checks = [("missing_outputs", lost, 0),
              ("logit_err", logit_err, lim["logit_err"]["limit"])]
    return checks, {"label_mismatch": differ / total,
                    "label_mismatch_median": float(np.median(shares)),
                    "images_compared": sum(1 for g in cap.out.values()
                                           if "labels" in g),
                    "logits_compared": n_logits}
