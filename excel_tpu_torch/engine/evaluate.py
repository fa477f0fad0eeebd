"""LAM evaluation at label resolution and in-training validation
(counterpart of the LAM and validation parts of
excel_tpu/engine/evaluate.py).

Per batch: normalise, encode, LAMs (training-free: the encoder alone with
its block-mean attention accumulated in the attention kernels; trained:
the flip-fused LVC-calibrated LAMs of the full model, with the head's
feature affinity as SVC's seg_attn), class-slot compaction, SVC, the
refined maps plus background upscaled to each image's valid extent on a
fixed canvas, PAR with per-image valid extents (fp32: the diffusion
kernel; bf16 under `fast()`: the pad-clamp, affinity and resident
diffusion kernels), argmax, and the confusion hist, all on the device.
The host sweep groups samples by canvas bucket and class-slot bucket,
resizes them in a background thread and can checkpoint its hist to resume
a killed sweep. In-training validation scores the pseudo-labels and the
head's segmentation in one pass.

MSC segmentation eval and the CRF branches belong to later slices.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..config import ExcelConfig
from ..data.loader import prefetch_iter
from ..data.resize import resize_bilinear
from ..device import resolve_device
from ..models.clip import encode_image
from ..models.excel import compute_lams, excel_forward
from ..ops.affinity import refine_lams_batch
from ..ops.labels import (argmax_label, cams_with_background_canvas,
                          class_slot_index, slot_label_to_class,
                          upscale_to_canvas, upscale_to_canvas_align)
from ..ops.par import par_refine
from ..utils.metrics import init_hist, scores_from_hist, update_hist
from .pipeline import attn_mode_for, normalize_images


# ---------------------------------------------------------------------------
# device steps
# ---------------------------------------------------------------------------

def _flip_fused_calibrated_lams(params, images, text_attr, cfg):
    """Calibrated LAMs of [x, flip x]: elementwise max after unflipping,
    per-map min-max normalised. Returns (lams [B, hw, C], the non-flipped
    half's encoder attention stack and attn_pred), which drive SVC."""
    b = images.shape[0]
    grid = images.shape[1] // cfg.clip.patch_size
    cat = torch.cat([images, images.flip(2)], dim=0)
    out = excel_forward(params, cat, text_attr, cfg)
    lams = excel_forward(params, cat, text_attr, cfg, ex_feats=out.fused)
    maps = lams.transpose(1, 2).reshape(2 * b, -1, grid, grid)
    fused = torch.maximum(maps[:b], maps[b:].flip(-1))
    fused = fused - fused.amin(dim=(-2, -1), keepdim=True)
    fused = fused / (fused.amax(dim=(-2, -1), keepdim=True) + 1e-5)
    lams = fused.reshape(b, -1, grid * grid).transpose(1, 2)
    return lams, out.attn_weights[:, :b], out.attn_pred[:b]


def _pseudo_on_canvas(lams, attn_weights, guide_images, cls_label, valid_hw,
                      cfg: ExcelConfig, canvas: tuple[int, int], caa: float,
                      seg_attn, class_slots: int | None = None):
    """SVC refine -> +bg upscaled to valid extents -> PAR -> argmax labels.
    Returns (labels [B, *canvas] int32, normed pre-PAR cams [B, 1+C,
    *canvas]).

    class_slots: compact to bg + `class_slots` present-class channels before
    SVC/upscale/PAR; exact when every image has <= class_slots present
    classes (callers bucket it from the batch's label cardinality)."""
    b, hw, c = lams.shape
    grid = int(round(hw ** 0.5))
    lams = lams.transpose(1, 2)                           # [B, C, hw]
    if class_slots is not None and class_slots < c:
        idx, smask = class_slot_index(cls_label, class_slots)
        lams = torch.gather(lams, 1, idx[:, :, None].expand(-1, -1, hw))
        cls_sel = smask
    else:
        class_slots = None
        cls_sel = cls_label
    refined = refine_lams_batch(
        lams, attn_weights, caa, (grid, grid),
        attn_layers=cfg.refine.attn_layers, seg_attn=seg_attn)
    normed = cams_with_background_canvas(
        refined.reshape(b, -1, grid, grid), cls_sel, valid_hw, canvas)
    # the reference PAR resizes its guidance with align_corners=True
    guide = upscale_to_canvas_align(guide_images, valid_hw, canvas)
    cams = par_refine(guide, normed,
                      dilations=tuple(cfg.refine.par_dilations),
                      num_iter=cfg.refine.par_iters, valid_hw=valid_hw,
                      dtype=torch.bfloat16 if cfg.refine.par_bf16 else None)
    if class_slots is not None:
        return slot_label_to_class(argmax_label(cams, cls_sel), idx), normed
    return argmax_label(cams, cls_label), normed


def lam_eval_step(params: dict, images_u8, cls_label, valid_hw, text_attr,
                  cfg: ExcelConfig, canvas: tuple[int, int],
                  mode: str = "training_free", return_cams: bool = False,
                  class_slots: int | None = None):
    """Pseudo-labels at label resolution for one resized batch, on the
    device its tensors are on.

    images_u8: [B, r, r, 3] float32 (host-resized, unnormalised 0-255);
    cls_label [B, num_fg]; valid_hw [B, 2] original label extents;
    text_attr [T, embed]. mode: "training_free" (params["clip"]) or
    "trained" (params["clip"] and params["head"]). Returns labels
    [B, *canvas] int32 (and the normed pre-PAR bg+class stack with
    return_cams=True)."""
    if mode not in ("training_free", "trained"):
        raise ValueError(mode)
    with torch.inference_mode():
        images = normalize_images(images_u8)
        if mode == "training_free":
            out = encode_image(params["clip"], images, cfg.clip,
                               attn_mode=attn_mode_for(cfg))
            lams = compute_lams(out, text_attr, cfg.num_fg)
            attn_w, seg_attn = out["attn"], None
        else:
            lams, attn_w, seg_attn = _flip_fused_calibrated_lams(
                params, images, text_attr, cfg)
        # PAR guidance: the NORMALISED resized input
        labels, cams = _pseudo_on_canvas(
            lams, attn_w, images.permute(0, 3, 1, 2), cls_label, valid_hw,
            cfg, canvas, cfg.refine.caa_threshold, seg_attn,
            class_slots=class_slots)
    return (labels, cams) if return_cams else labels


def lam_eval_hist_step(hist, params: dict, images_u8, cls_label, gt_labels,
                       valid_hw, text_attr, cfg: ExcelConfig,
                       canvas: tuple[int, int], mode: str = "training_free",
                       class_slots: int | None = None):
    """lam_eval_step followed by the confusion-hist update on the device;
    returns the updated [C, C] hist."""
    preds = lam_eval_step(params, images_u8, cls_label, valid_hw, text_attr,
                          cfg, canvas, mode, class_slots=class_slots)
    return update_hist(hist, gt_labels, preds, cfg.num_classes)


def val_step(params: dict, images_u8, cls_label, valid_hw, text_attr,
             cfg: ExcelConfig, canvas: tuple[int, int],
             class_slots: int | None = None):
    """In-training validation of one batch: (pseudo-labels at the
    validation caa threshold with attn_pred as seg_attn, the head's
    segmentation argmax), both [B, *canvas] int32."""
    with torch.inference_mode():
        images = normalize_images(images_u8)
        out = excel_forward(params, images, text_attr, cfg)
        pseudos, _ = _pseudo_on_canvas(
            out.lams, out.attn_weights, images.permute(0, 3, 1, 2),
            cls_label, valid_hw, cfg, canvas, cfg.refine.val_caa_threshold,
            out.attn_pred, class_slots=class_slots)
        b, hw, c = out.segs.shape
        grid = int(round(hw ** 0.5))
        seg_grid = out.segs.transpose(1, 2).reshape(b, c, grid, grid)
        segs = upscale_to_canvas(seg_grid, valid_hw, canvas).argmax(dim=1)
    return pseudos, segs.to(torch.int32)


def val_hist_step(hist_p, hist_s, params: dict, images_u8, cls_label,
                  gt_labels, valid_hw, text_attr, cfg: ExcelConfig,
                  canvas: tuple[int, int], class_slots: int | None = None):
    """val_step followed by both confusion-hist updates on the device."""
    pseudos, segs = val_step(params, images_u8, cls_label, valid_hw,
                             text_attr, cfg, canvas, class_slots=class_slots)
    return (update_hist(hist_p, gt_labels, pseudos, cfg.num_classes),
            update_hist(hist_s, gt_labels, segs, cfg.num_classes))


# ---------------------------------------------------------------------------
# host sweeps
# ---------------------------------------------------------------------------

def _prep_batch(samples: list[dict], resize: int, canvas: tuple[int, int]):
    """Full-size eval samples -> (images [B,r,r,3] f32, cls [B,C], labels
    [B,*canvas] 255-padded, valid_hw [B,2])."""
    ch, cw = canvas
    images, labels, cls, valid = [], [], [], []
    for s in samples:
        images.append(resize_bilinear(s["image"], (resize, resize)))
        lab = np.full((ch, cw), 255, np.int32)
        h, w = s["label"].shape
        h, w = min(h, ch), min(w, cw)
        lab[:h, :w] = s["label"][:h, :w]
        labels.append(lab)
        cls.append(s["cls_label"])
        valid.append((h, w))
    return (np.stack(images), np.stack(cls).astype(np.float32),
            np.stack(labels), np.asarray(valid, np.int32))


def _bucket_of(sample, pad: int, q: int = 128) -> tuple[int, int]:
    """Quantised canvas bucket of one sample's label extent, capped at the
    eval pad: width to `q`=128, height to 32."""
    h, w = sample["label"].shape
    hq = min(q, 32)
    return (min(-(-h // hq) * hq, pad), min(-(-w // q) * q, pad))


def _slot_need_bucket(need: int, num_fg: int, buckets) -> int | None:
    """Smallest slot bucket covering `need` present classes (None = full
    stack)."""
    for b in sorted(buckets):
        if need <= b < num_fg:
            return b
    return None


def _slots_bucket(cls_batch, num_fg: int,
                  buckets=(2, 3, 4, 5, 6, 8, 12, 16)) -> int | None:
    """Smallest slot bucket covering the batch's max label cardinality."""
    need = int(np.asarray(cls_batch > 0).sum(axis=1).max()) if len(
        np.shape(cls_batch)) else num_fg
    return _slot_need_bucket(need, num_fg, buckets)


def _bucketed_batches(dataset, batch_size: int, pad: int,
                      slot_buckets=None, num_fg: int | None = None):
    """Group samples into canvas (and class-slot) buckets; yield
    (canvas_hw, samples) with full batches, remainders padded with all-255
    GT blanks (they add nothing to the hist)."""
    buckets: dict = {}
    for i in range(len(dataset)):
        s = dataset[i]
        key = _bucket_of(s, pad)
        if slot_buckets is not None:
            need = int(np.asarray(s["cls_label"] > 0).sum())
            key = key + (_slot_need_bucket(need, num_fg, slot_buckets),)
        buf = buckets.setdefault(key, [])
        buf.append(s)
        if len(buf) == batch_size:
            yield key[:2], buf
            buckets[key] = []
    for key, buf in buckets.items():
        if not buf:
            continue
        blank_src = buf[-1]
        while len(buf) < batch_size:
            blank = dict(blank_src)
            blank["label"] = np.full_like(blank_src["label"], 255)
            blank["_pad"] = True
            buf.append(blank)
        yield key[:2], buf


def _sweep_resume(path: str | None, fingerprint: str, num_classes: int,
                  device):
    """-> (hist, batches_done); restores only a checkpoint whose fingerprint
    matches, so a changed protocol restarts rather than mixing hists."""
    if path and os.path.exists(path):
        with np.load(path) as d:
            if str(d["fingerprint"]) == fingerprint:
                return (torch.from_numpy(d["hist"]).long().to(device),
                        int(d["done"]))
    return init_hist(num_classes, device), 0


def _sweep_save(path: str | None, hist, done: int, fingerprint: str) -> None:
    if not path:
        return
    tmp = path + ".tmp.npz"
    np.savez(tmp, hist=hist.cpu().numpy(), done=done,
             fingerprint=fingerprint)
    os.replace(tmp, path)            # atomic: a kill never corrupts


def _sweep_done(path: str | None) -> None:
    if path and os.path.exists(path):
        os.remove(path)


def _skip_batches(gen, start: int):
    for i, item in enumerate(gen):
        if i >= start:
            yield item


def run_lam_eval(params: dict, dataset, text_attr, cfg: ExcelConfig,
                 mode: str = "training_free", batch_size: int = 4,
                 resize: int | None = None,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 100, device="cuda"):
    """LAM pseudo-label sweep -> scores dict.

    dataset: len() and [i] -> {"image" uint8 [h,w,3], "label" int [h,w],
    "cls_label" [num_fg]}. params and text_attr must already be on
    `device`. checkpoint_path: periodic hist + progress checkpoint (about
    every `checkpoint_every` images) that a rerun with the same protocol
    resumes from."""
    device = resolve_device(device)
    resize = resize or cfg.clip.image_size
    fp = (f"lam:sg1:{len(dataset)}:{batch_size}:{mode}:{resize}:"
          f"{cfg.num_classes}:{cfg.data.eval_pad}:proc0/1")
    hist, start = _sweep_resume(checkpoint_path, fp, cfg.num_classes, device)
    n_done = start * batch_size
    last_saved = n_done
    sb = cfg.refine.slot_buckets
    prepped = prefetch_iter(
        (cv, b, _prep_batch(b, resize, cv))
        for cv, b in _skip_batches(
            _bucketed_batches(dataset, batch_size, cfg.data.eval_pad,
                              slot_buckets=sb, num_fg=cfg.num_fg),
            start))
    for canvas, samples, (images, cls, labels, valid) in prepped:
        slots = _slots_bucket(cls, cfg.num_fg, sb)
        images, cls, labels, valid = (
            torch.from_numpy(a).to(device, non_blocking=True)
            for a in (images, cls, labels, valid))
        hist = lam_eval_hist_step(hist, params, images, cls, labels, valid,
                                  text_attr, cfg, canvas, mode,
                                  class_slots=slots)
        n_done += len(samples)
        if checkpoint_path and n_done - last_saved >= checkpoint_every:
            _sweep_save(checkpoint_path, hist, n_done // batch_size, fp)
            last_saved = n_done
    _sweep_done(checkpoint_path)
    return scores_from_hist(hist)


def run_validation(params: dict, dataset, text_attr, cfg: ExcelConfig,
                   batch_size: int = 4, device="cuda"):
    """In-training validation sweep -> (pseudo-label scores, seg scores).
    params (clip and head) and text_attr must already be on `device`."""
    device = resolve_device(device)
    hist_p = init_hist(cfg.num_classes, device)
    hist_s = init_hist(cfg.num_classes, device)
    sb = cfg.refine.slot_buckets
    prepped = prefetch_iter(
        (cv, b, _prep_batch(b, cfg.clip.image_size, cv))
        for cv, b in _bucketed_batches(dataset, batch_size, cfg.data.eval_pad,
                                       slot_buckets=sb, num_fg=cfg.num_fg))
    for canvas, _, (images, cls, labels, valid) in prepped:
        slots = _slots_bucket(cls, cfg.num_fg, sb)
        images, cls, labels, valid = (
            torch.from_numpy(a).to(device, non_blocking=True)
            for a in (images, cls, labels, valid))
        hist_p, hist_s = val_hist_step(hist_p, hist_s, params, images, cls,
                                       labels, valid, text_attr, cfg, canvas,
                                       class_slots=slots)
    return scores_from_hist(hist_p), scores_from_hist(hist_s)
