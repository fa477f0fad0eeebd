"""The cells' outputs for one image, from the raw image the benchmark made.

- `lam_sweep`: restates engine/evaluate.py's training-free LAM step
  (`lam_eval_step`, `_pseudo_on_canvas`) at label resolution: resize to
  the encoder's size (data/resize.py: half-pixel bilinear, no
  antialiasing), normalise, encode, LAMs, SVC over the image's present
  classes, each refined map min-max normalised and upscaled to the image's
  size (ops/labels.py `cams_with_background_canvas`), background 1 - max,
  the normalised input upscaled with aligned corners as PAR's guide, PAR,
  argmax over background and present classes.
- `msc`: restates `run_msc_seg_eval`'s per-image work (`msc_hist_step`):
  per scale the image resized to int(base * scale), the encoder without
  attention output, the head's logits on the token grid, the flip's
  logits unflipped and averaged (not at scale 1.0), upscaled to the
  image's size and summed over the scales.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import encoder, head, par, svc
from .precision import FP32


def resize(image, size):
    """[h, w, 3] -> [size, size, 3] float32, half-pixel bilinear."""
    x = image.float().permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False)
    return x[0].permute(1, 2, 0)


def upscale(x, hw, align=False):
    return F.interpolate(x[None].float(), size=tuple(hw), mode="bilinear",
                         align_corners=align)[0]


def lam_image(m, raw, cls, prec=FP32):
    """m: the cell's model numbers and tensors (see harness/checks.py);
    raw [h, w, 3] uint8 on the device, cls [num_fg] {0, 1}.
    Returns {"lams" [hw, num_fg], "attn" [N, N], "cams" [1+K, h, w],
    "labels" [h, w] int64 class ids, "guide" [3, h, w] PAR's guide}."""
    h, w = raw.shape[:2]
    x = encoder.normalize(resize(raw, m["size"]))
    out = encoder.vision_forward(m["visual"], x, m["heads"], m["surgery"],
                                 m["window"], prec)
    lam = encoder.lams(out["projected"], m["text"], m["num_fg"])
    present = torch.nonzero(cls > 0).flatten()
    guide = upscale(x.permute(2, 0, 1), (h, w), align=True)
    cams = cams_from_state(m, lam[:, present].t(), out["attn"][1:, 1:],
                           guide, prec)
    return {"lams": lam, "attn": out["attn"], "cams": cams,
            "labels": class_ids(present)[cams.argmax(dim=0)],
            "guide": guide}


def class_ids(present):
    """The class id of each map: background, then the present classes."""
    return torch.cat([torch.zeros(1, dtype=torch.long,
                                  device=present.device), present + 1])


def cams_from_state(m, lams, attn, guide, prec=FP32):
    """From the LAMs [P, hw] of an image's present classes and the
    attention [hw, hw] that drives SVC: SVC, each refined map min-max
    normalised and upscaled to the guide's size, background 1 - max, PAR
    along the guide [3, h, w]. Returns the maps [1+P, h, w]."""
    grid = int(round(lams.shape[1] ** 0.5))
    refined = svc.refine(lams.float(), attn.float(), m["caa"],
                         grid).reshape(-1, grid, grid)
    refined = refined - refined.amin(dim=(1, 2), keepdim=True)
    refined = refined / (1e-7 + refined.amax(dim=(1, 2), keepdim=True))
    up = upscale(refined, guide.shape[-2:])
    cams = torch.cat([1.0 - up.amax(dim=0, keepdim=True), up])
    return par.refine(guide, cams, m["dilations"], m["iters"], prec=prec)


def label_gap(cams, present, labels):
    """By how far the map of each pixel's label lies below the best map at
    that pixel: cams [1+P, h, w] over background and the present classes,
    labels [h, w] class ids -> [h, w]. A tie reads 0, so a label that
    rounding decides between near-equal maps costs nothing; a label that
    is neither background nor a present class counts as a map of -1
    (every map is at least 0)."""
    ids = class_ids(present)
    lut = torch.full((max(int(labels.max()), int(ids.max())) + 1,), -1,
                     dtype=torch.long, device=cams.device)
    lut[ids] = torch.arange(len(ids), device=cams.device)
    idx = lut[labels.long().clamp(min=0)]
    picked = torch.gather(cams, 0, idx.clamp(min=0)[None])[0]
    picked = torch.where(idx >= 0, picked, torch.full_like(picked, -1.0))
    return cams.amax(dim=0) - picked


MISS_GAP = 0.05
GAP_STEPS = (0.02, MISS_GAP, 0.1)


def gap_summary(gap) -> dict:
    """An image's label gaps: the widest, and the share of its pixels
    whose gap passes each of GAP_STEPS ("miss": MISS_GAP's, six bfloat16
    steps of a map near 1; the bfloat16 PAR's 20 steps move a map by up
    to 0.02-0.05 where two classes nearly tie, PERF.md)."""
    out = {"max": float(gap.max())}
    for t in GAP_STEPS:
        out["miss" if t == MISS_GAP else f"over_{t}"] = float(
            (gap > t).float().mean())
    return out


def seg_logits(m, image, prec=FP32):
    """One resized image [s, s, 3] (0-255) -> the head's logits [C, g, g]."""
    out = encoder.vision_forward(m["visual"], encoder.normalize(image),
                                 m["heads"], m["surgery"], m["window"], prec,
                                 need_attn=False)
    feats = out["feats"][:, 1:, :]
    g = image.shape[0] // m["patch"]
    fused = head.fuse(m["head"], feats, m["head_blocks"])
    logits, _ = head.decoder(m["head"], fused, m["head_layers"],
                             m["head_heads"])
    return logits.t().reshape(-1, g, g)


def msc_image(m, raw, prec=FP32):
    """-> {"logits" [C, h, w] summed over the scales, "labels" [h, w]}."""
    h, w = raw.shape[:2]
    acc = None
    for sc in m["scales"]:
        img = resize(raw, int(m["size"] * sc))
        logits = seg_logits(m, img, prec)
        if sc != 1.0:
            flipped = seg_logits(m, img.flip(1), prec)
            logits = (logits + flipped.flip(-1)) / 2.0
        up = upscale(logits, (h, w))
        acc = up if acc is None else acc + up
    return {"logits": acc, "labels": acc.argmax(dim=0)}
