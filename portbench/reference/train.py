"""Training steps of the LVC head, in float32 from the raw crops.

Restates excel_tpu_torch/engine/train.py (`train_losses`, `train_step`,
`lr_schedule`, the phases), engine/pipeline.py (`pseudo_labels` at crop
resolution, `denormalize_images`), ops/labels.py (`affinity_label`, the
radius mask), models/losses.py (`seg_loss`, `aff_loss`), models/head.py
(`dropout2d`, the dropout's draw from the step's generator seeded
(seed << 32) + step) and torch.optim.AdamW's update, one image at a time
where the program batches. The head's parameters are leaves of autograd;
the encoder runs without it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import encoder, head, pipeline, svc
from .encoder import normalize
from .precision import FP32


def lr_at(t: dict, step: int) -> float:
    """The poly schedule with linear warmup, in float32."""
    f = np.float32
    base = f(t["lr"] * 10.0)
    w, t_max, power = f(t["warmup_iters"]), f(t["max_iters"]), f(t["power"])
    s = f(step)
    warm = f(t["warmup_ratio"]) + f(1.0 - t["warmup_ratio"]) * s / w
    rest = max(f(1.0) - s / t_max, f(0.0)) ** power
    return float(base * (warm if s < w else rest))


def denormalize(images_u8):
    """The PAR guide of training: floor(x * std + mean) / 255 of the
    normalised crop, x * std + mean formed in float64 from the float32
    constants and rounded once to float32, the division a product with
    the float32 reciprocal of 255."""
    x = normalize(images_u8)
    std = torch.tensor(encoder.IMAGENET_STD, device=x.device).double()
    mean = torch.tensor(encoder.IMAGENET_MEAN, device=x.device).double()
    y = (x.double() * std + mean).float()
    return torch.clamp(torch.floor(y), 0, 255) * (1.0 / 255.0)


def affinity_target(label, grid, radius, ignore=255, down=16):
    small = label[::down, ::down][:grid, :grid].reshape(-1)
    aff = (small[None, :] == small[:, None]).long()
    ys, xs = np.mgrid[0:grid, 0:grid]
    ys, xs = ys.ravel(), xs.ravel()
    near = torch.from_numpy((np.abs(ys[:, None] - ys[None, :]) <= radius)
                            & (np.abs(xs[:, None] - xs[None, :]) <= radius)
                            ).to(label.device)
    aff = torch.where(near, aff, torch.full_like(aff, ignore))
    bad = small == ignore
    aff = torch.where(bad[None, :] | bad[:, None],
                      torch.full_like(aff, ignore), aff)
    return aff


def _ce_sum(logits, labels, valid):
    logp = torch.log_softmax(logits, dim=0)
    c = logits.shape[0]
    lab = labels.clamp(0, c - 1)
    picked = torch.gather(logp, 0, lab[None])[0]
    picked = torch.where((labels >= 0) & (labels < c), picked,
                         torch.zeros_like(picked))
    return -(picked * valid).sum()


def step_losses(m, hp, images_u8, cls, step, prec=FP32, keep_rows=None):
    """The total, seg and diversity losses of one batch (autograd through
    the head's parameters hp), and what SVC and PAR made the pseudo-labels
    from: {"pseudos" [B, S, S], "lams" [B, hw, num_fg] (the calibrated
    pass's where the step is calibrated), "attn" [B, hw, hw] (the
    attention that drives SVC)}."""
    t = m["train"]
    calibrated = step >= t["lvc_calibrate_iter"]
    seg_aff = step >= t["seg_affinity_iter"]
    b = images_u8.shape[0]
    size, patch = images_u8.shape[1], m["patch"]
    grid = size // patch
    x = normalize(images_u8)
    guide = denormalize(images_u8).permute(0, 3, 1, 2)
    g = torch.Generator(device=images_u8.device)
    g.manual_seed((int(t["seed"]) << 32) + int(step))
    rate = m["dropout"]
    keep = (torch.rand((b, 1, m["embed"]), generator=g,
                       device=images_u8.device) < 1.0 - rate).float() \
        / (1.0 - rate)
    outs, fused, segs, grams = [], [], [], []
    for i in range(b):
        with torch.no_grad():
            o = encoder.vision_forward(m["visual"], x[i], m["heads"],
                                       m["surgery"], m["window"], prec,
                                       stack=calibrated)
        outs.append(o)
        f = head.fuse(hp, o["feats"][:, 1:, :], m["head_blocks"],
                      keep=keep[i, 0])
        fused.append(f)
        logits, _ = head.decoder(hp, f, m["head_layers"], m["head_heads"])
        segs.append(logits)
        grams.append(head.feature_gram(f))
    gram_mean = torch.stack(grams).mean()
    attn_pred = [head.feature_affinity(gm, gram_mean) for gm in grams]
    lams = [encoder.lams(o["projected"], m["text"], m["num_fg"])
            for o in outs]
    if calibrated:
        with torch.no_grad():
            sims = [encoder.feature_sim(f.detach()) for f in fused]
            sim_mean = torch.stack(sims).mean()
            lams = []
            for i in range(b):
                ex = encoder.external_feature_attention_from_sim(
                    sims[i], sim_mean)
                o2 = encoder.vision_forward(m["visual"], x[i], m["heads"],
                                            m["surgery"], m["window"], prec,
                                            ex_attn=ex, need_attn=False)
                lams.append(encoder.lams(o2["projected"], m["text"],
                                         m["num_fg"]))
    pseudos, attns = [], []
    with torch.no_grad():
        for i in range(b):
            present = torch.nonzero(cls[i] > 0).flatten()
            if calibrated:
                attn = svc.aggregate_attn(outs[i]["stack"][:, 1:, 1:],
                                          attn_pred[i].detach())
            else:
                attn = outs[i]["attn"][1:, 1:]
            attns.append(attn)
            cams = pipeline.cams_from_state(m, lams[i][:, present].t(),
                                            attn, guide[i], prec)
            pseudos.append(pipeline.class_ids(present)[cams.argmax(dim=0)])
    rows = range(b) if keep_rows is None else keep_rows
    seg_up = [F.interpolate(segs[i].t().reshape(1, -1, grid, grid),
                            size=(size, size), mode="bilinear",
                            align_corners=False)[0] for i in range(b)]
    bg_sum = fg_sum = 0.0
    bg_n = fg_n = 0
    for i in rows:
        lab = pseudos[i]
        valid = lab != 255
        bg = (valid & (lab == 0)).float()
        fg = (valid & (lab != 0)).float()
        bg_sum = bg_sum + _ce_sum(seg_up[i], lab, bg)
        fg_sum = fg_sum + _ce_sum(seg_up[i], lab, fg)
        bg_n += int(bg.sum())
        fg_n += int(fg.sum())
    l_seg = (bg_sum / (bg_n + 1e-6) + fg_sum / (fg_n + 1e-6)) * 0.5
    pos_sum = neg_sum = 0.0
    pos_n = neg_n = 0
    for i in rows:
        src = seg_up[i].detach().argmax(dim=0) if seg_aff else pseudos[i]
        tgt = affinity_target(src, grid, m["radius"])
        pos = (tgt == 1).float()
        neg = (tgt == 0).float()
        pos_sum = pos_sum + (pos * (1.0 - attn_pred[i])).sum()
        neg_sum = neg_sum + (neg * attn_pred[i]).sum()
        pos_n += int(pos.sum())
        neg_n += int(neg.sum())
    l_aff = 0.5 * pos_sum / (pos_n + 1.0) + 0.5 * neg_sum / (neg_n + 1.0)
    total = t["w_seg"] * l_seg + t["w_diver"] * l_aff
    state = {"pseudos": torch.stack(pseudos), "lams": torch.stack(lams),
             "attn": torch.stack(attns)}
    return total, l_seg, l_aff, state


class AdamW:
    """torch.optim.AdamW's update (decoupled decay, bias corrections),
    one state a leaf."""

    def __init__(self, params: dict, betas, eps, weight_decay):
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float) -> None:
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            p.mul_(1 - lr * self.wd)
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            denom = (self.v[k].sqrt() / bc2 ** 0.5) + self.eps
            p.add_(-(lr / bc1) * self.m[k] / denom)


def run_steps(m, init: dict, batches, steps, prec=FP32, keep_rows=None):
    """The reference's steps from the head's initial values `init` over
    [(images_u8, cls)] at the global steps `steps`. Returns {"losses",
    "grads" (the first step's), "params" (after the last step), "first"
    (the first step's SVC and PAR inputs and pseudo-labels, as
    `step_losses` gives them)}."""
    t = m["train"]
    params = {k: v.detach().float().clone().requires_grad_(True)
              for k, v in init.items()}
    opt = AdamW(params, t["betas"], 1e-8, t["weight_decay"])
    losses, first_grads, first = [], None, None
    for (images, cls), step in zip(batches, steps):
        total, _, _, state = step_losses(m, params, images, cls, step, prec,
                                         keep_rows)
        if first is None:
            first = state
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                 for k, g in zip(params, grads)}
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(total.detach()))
        opt.step(params, grads, lr_at(t, step))
    return {"losses": losses, "grads": first_grads,
            "params": {k: v.detach() for k, v in params.items()},
            "first": first}
