"""Evaluation protocols: LAM evaluation at label resolution, in-training
validation and MSC+flip segmentation eval, each with the optional on-device
CRF (counterpart of excel_tpu/engine/evaluate.py).

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

MSC+flip segmentation eval (the final segmentation score): per scale the
resized batch and its horizontal flip go through the full forward as one
batch of 2B with the encoder's attention outputs skipped, the unflipped
logits are averaged (scale 1.0 keeps only the non-flipped logits, a quirk
of the reference, so its flip is not computed), upscaled to each image's
valid extent and summed over scales on the canvas; then the argmax, or
first the convolutional mean-field CRF (ops/crf_tpu.py) on their softmax
against the canvas-resolution image. The LAM sweep has the same CRF branch
over its pre-PAR class maps.

Multi-device: one process a device. Each rank of a process group sweeps
its own shard of the dataset (`parallel.distributed.shard_dataset`) and
the sweeps sum their hists over the ranks (`global_sum_host`) before
scoring, as the JAX package does across processes; its `mesh` argument,
which spreads one process's batch over its local devices, has no
counterpart, since here a host's devices are ranks of their own.
"""
from __future__ import annotations

import dataclasses
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
from ..ops.crf_tpu import crf_meanfield_cfg
from ..ops.labels import (argmax_label, cams_with_background_canvas,
                          class_slot_index, slot_label_to_class,
                          upscale_to_canvas, upscale_to_canvas_align)
from ..ops.par import fill_counts, par_refine
from ..parallel.distributed import global_sum_host, rank, world
from ..utils import profiling
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
    with profiling.span("labels"):
        b, hw, c = lams.shape
        grid = int(round(hw ** 0.5))
        lams = lams.transpose(1, 2)                       # [B, C, hw]
        if class_slots is not None and class_slots < c:
            idx, smask = class_slot_index(cls_label, class_slots)
            lams = torch.gather(lams, 1,
                                idx[:, :, None].expand(-1, -1, hw))
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
        cams = par_refine(
            guide, normed, dilations=tuple(cfg.refine.par_dilations),
            num_iter=cfg.refine.par_iters, valid_hw=valid_hw,
            dtype=torch.bfloat16 if cfg.refine.par_bf16 else None)
        if class_slots is not None:
            slot = argmax_label(cams, cls_sel,
                                ignore_index=cfg.refine.ignore_index)
            return slot_label_to_class(slot, idx), normed
        labels = argmax_label(cams, cls_label,
                              ignore_index=cfg.refine.ignore_index)
        return labels, normed


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
    with torch.inference_mode(), profiling.span(
            "step", images=images_u8.shape[0]):
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


def lam_crf_refine(cams, canvas_images_u8, cls_label, valid_hw,
                   cfg: ExcelConfig, class_slots: int | None = None):
    """The on-device CRF branch of the LAM protocol: conv mean-field over
    the pre-PAR normed bg + class stack against the canvas-resolution
    image, slot argmax mapped back to class ids. cams [B, 1+K, H, W] ->
    [B, H, W] int32 class ids. Approximate against the host lattice CRF,
    which stays the exact-form path."""
    with torch.inference_mode():
        q = crf_meanfield_cfg(canvas_images_u8, cams, cfg.crf,
                              valid_hw=valid_hw)
        slot = q.argmax(dim=1).to(torch.int32)
        if class_slots is None:
            return slot              # full stack: channel s IS class id s
        idx, _ = class_slot_index(cls_label, class_slots)
        return slot_label_to_class(slot, idx)


def lam_crf_hist_step(hist, crf_hist, params: dict, images_u8, cls_label,
                      gt_labels, valid_hw, canvas_images_u8, text_attr,
                      cfg: ExcelConfig, canvas: tuple[int, int],
                      mode: str = "training_free",
                      class_slots: int | None = None):
    """lam_eval_hist_step with the on-device CRF branch: returns the raw
    and the CRF [C, C] hists."""
    preds, cams = lam_eval_step(params, images_u8, cls_label, valid_hw,
                                text_attr, cfg, canvas, mode,
                                return_cams=True, class_slots=class_slots)
    hist = update_hist(hist, gt_labels, preds, cfg.num_classes)
    crf_preds = lam_crf_refine(cams, canvas_images_u8, cls_label, valid_hw,
                               cfg, class_slots=class_slots)
    return hist, update_hist(crf_hist, gt_labels, crf_preds, cfg.num_classes)


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


def seg_grid_logits(params: dict, images_u8, text_attr, cfg: ExcelConfig):
    """Forward -> decoder logits on the token grid, [B, C, g, g], for any
    input size (one per MSC scale). The encoder's attention outputs are
    skipped (attn_mode="none"): the seg branch never reads them."""
    with torch.inference_mode():
        out = excel_forward(params, normalize_images(images_u8), text_attr,
                            cfg, attn_mode="none")
        b, hw, c = out.segs.shape
        grid = int(round(hw ** 0.5))
        return out.segs.transpose(1, 2).reshape(b, c, grid, grid)


def msc_accumulate(params: dict, images_u8, valid_hw, text_attr,
                   cfg: ExcelConfig, canvas: tuple[int, int], acc,
                   keep_flip: bool = True):
    """One MSC scale: forward [x, flip x] as one batch, unflip, average (or
    with keep_flip=False, scale 1.0, forward only x: the reference computes
    the flipped half there and discards it), upscale to the valid extents,
    add onto the canvas accumulator [B, C, *canvas]."""
    b = images_u8.shape[0]
    with torch.inference_mode():
        if keep_flip:
            cat = torch.cat([images_u8, images_u8.flip(2)], dim=0)   # W axis
            logits = seg_grid_logits(params, cat, text_attr, cfg)
            fused = (logits[:b] + logits[b:].flip(-1)) / 2.0
        else:
            fused = seg_grid_logits(params, images_u8, text_attr, cfg)
        return acc + upscale_to_canvas(fused, valid_hw, canvas)


def canvas_argmax(acc):
    return acc.argmax(dim=1).to(torch.int32)


def msc_hist_step(hist, params: dict, scale_images: tuple, gt_labels,
                  valid_hw, text_attr, cfgs: tuple, canvas: tuple[int, int],
                  keep_flips: tuple, canvas_images=None, use_crf: bool = False,
                  return_outputs: bool = False):
    """All MSC scales + flip fusion + (optional on-device CRF) + argmax +
    hist update for one batch; the accumulator and the predictions stay on
    the device. scale_images: per scale the resized batch [B, s, s, 3];
    cfgs: per scale the config with that image size; keep_flips: per scale
    whether the flip is fused; canvas_images [B, *canvas, 3] uint8 with
    use_crf. Returns the hist, or with return_outputs (hist, summed logits,
    preds) for per-image dumps; the logits are always pre-CRF (the
    reference saves raw fused logits and runs its host CRF on those)."""
    cfg0 = cfgs[0]
    b = scale_images[0].shape[0]
    with profiling.span("step", images=b):
        acc = torch.zeros((b, cfg0.num_classes, *canvas),
                          dtype=torch.float32, device=scale_images[0].device)
        for imgs, c, kf in zip(scale_images, cfgs, keep_flips):
            acc = msc_accumulate(params, imgs, valid_hw, text_attr, c,
                                 canvas, acc, keep_flip=kf)
        logits = acc
        with torch.inference_mode():
            if use_crf:
                acc = crf_meanfield_cfg(canvas_images,
                                        torch.softmax(acc, dim=1), cfg0.crf,
                                        valid_hw=valid_hw)
            preds = canvas_argmax(acc)
            hist = update_hist(hist, gt_labels, preds, cfg0.num_classes)
    return (hist, logits, preds) if return_outputs else hist


# ---------------------------------------------------------------------------
# host sweeps
# ---------------------------------------------------------------------------

def _prep_batch(samples: list[dict], resize: int, canvas: tuple[int, int],
                with_canvas_images: bool = False):
    """Full-size eval samples -> (images [B,r,r,3] f32, cls [B,C], labels
    [B,*canvas] 255-padded, valid_hw [B,2][, canvas_images [B,*canvas,3]
    uint8, zero beyond each image])."""
    with profiling.span("prep"):
        ch, cw = canvas
        images, labels, cls, valid, canv = [], [], [], [], []
        for s in samples:
            images.append(resize_bilinear(s["image"], (resize, resize)))
            lab = np.full((ch, cw), 255, np.int32)
            h, w = s["label"].shape
            h, w = min(h, ch), min(w, cw)
            lab[:h, :w] = s["label"][:h, :w]
            labels.append(lab)
            cls.append(s["cls_label"])
            valid.append((h, w))
            if with_canvas_images:
                ci = np.zeros((ch, cw, 3), np.uint8)
                ci[:h, :w] = s["image"][:h, :w]
                canv.append(ci)
        out = (np.stack(images), np.stack(cls).astype(np.float32),
               np.stack(labels), np.asarray(valid, np.int32))
        return out + (np.stack(canv),) if with_canvas_images else out


def _prep_msc_batch(samples: list[dict], base: int, canvas: tuple[int, int],
                    scales, with_canvas_images: bool = False):
    """-> (`_prep_batch` at the base size, per scale the images [B, s, s, 3]
    f32 resized to s = int(base * scale))."""
    with profiling.span("prep.msc"):
        prep = _prep_batch(samples, base, canvas, with_canvas_images)
        return prep, tuple(
            np.stack([resize_bilinear(s["image"], (int(base * sc),) * 2)
                      for s in samples]) for sc in scales)


def _scale_cfgs(cfg: ExcelConfig, base: int, scales) -> tuple:
    """Per MSC scale the config whose image size is int(base * scale)."""
    return tuple(dataclasses.replace(cfg, clip=dataclasses.replace(
        cfg.clip, image_size=int(base * sc))) for sc in scales)


def _bucket_of(sample, pad: int, q: int = 128) -> tuple[int, int]:
    """Quantised canvas bucket of one sample's label extent, capped at the
    eval pad: width to `q`=128, height to 32."""
    h, w = sample["label"].shape
    hq = min(q, 32)
    return (min(-(-h // hq) * hq, pad), min(-(-w // q) * q, pad))


def _batched(dataset, batch_size):
    """Samples in dataset order in batches of `batch_size`, the last filled
    up with copies of its last sample whose labels are all 255 (they add
    nothing to a hist) and marked `_pad`."""
    buf = []
    for i in range(len(dataset)):
        buf.append(dataset[i])
        if len(buf) == batch_size:
            yield buf
            buf = []
    if buf:
        pad = buf[-1]
        while len(buf) < batch_size:
            blank = dict(pad)
            blank["label"] = np.full_like(pad["label"], 255)
            blank["_pad"] = True
            buf.append(blank)
        yield buf


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
        with profiling.span("read"):
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


def _rank_path(path: str | None) -> str | None:
    """A sweep checkpoint of its own for each rank of a group (the ranks'
    partial hists must not share one file)."""
    return f"{path}.p{rank()}" if path and world() > 1 else path


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


def _count_batch(samples: list, prep=None, canvas=None, num_fg=None,
                 slots=None) -> None:
    """The sweep's counters of one batch: `batches`, `images` and, for a
    LAM batch (its `_prep_batch` arrays, canvas and class-slot bucket),
    PAR's `par.refined` and `par.useful` channel-pixels
    (`ops/par.fill_counts`; blank remainders are useless)."""
    profiling.count("batches")
    profiling.count("images", len(samples))
    if prep is not None:
        refined, useful = fill_counts(
            prep[1], prep[3], canvas,
            1 + (num_fg if slots is None else slots),
            [bool(s.get("_pad")) for s in samples])
        profiling.count("par.refined", refined)
        profiling.count("par.useful", useful)


def _to_device(arrays, device: torch.device):
    """numpy arrays -> tensors on `device`. A CUDA copy is staged in pinned
    host memory, so that it runs asynchronously (a copy from pageable memory
    waits for the device even with non_blocking=True); on the CPU the
    tensors share the arrays' memory."""
    if device.type != "cuda":
        return tuple(torch.from_numpy(a) for a in arrays)
    with profiling.span("to_device"):
        return tuple(torch.from_numpy(a).pin_memory().to(device,
                                                         non_blocking=True)
                     for a in arrays)


def _dump_batch(hist, crf_hist, params, samples, images, cls, labels, valid,
                canvas_imgs, text_attr, cfg, canvas, mode, slots, crf_tpu,
                save_cam, save_lam_crf):
    """One batch of a `run_lam_eval` sweep that hands each image's maps to
    save_cam / save_lam_crf: returns the updated (hist, crf_hist)."""
    preds, cams = lam_eval_step(params, images, cls, valid, text_attr, cfg,
                                canvas, mode, return_cams=True,
                                class_slots=slots)
    hist = update_hist(hist, labels, preds, cfg.num_classes)
    if crf_tpu:
        crf_preds = lam_crf_refine(cams, canvas_imgs[0], cls, valid, cfg,
                                   class_slots=slots)
        crf_hist = update_hist(crf_hist, labels, crf_preds, cfg.num_classes)
    cams_np = cams.cpu().numpy()
    for i, s in enumerate(samples):
        if s.get("_pad"):   # remainder padding: no file emission
            continue
        h, w = s["label"].shape
        if save_cam:
            save_cam(s["name"], s["image"][:h, :w], cams_np[i, :, :h, :w])
        if save_lam_crf:
            keys = np.flatnonzero(np.asarray(s["cls_label"]) > 0)
            if slots is None:
                # full stack: channel c+1 is fg class c
                chans = np.concatenate(([0], keys + 1))
                valid_lam = cams_np[i][chans][:, :h, :w]
            else:
                # compacted: present classes ascending in slots 1..K
                valid_lam = cams_np[i, :1 + len(keys), :h, :w]
            save_lam_crf(s["name"], valid_lam, keys)
    return hist, crf_hist


def run_lam_eval(params: dict, dataset, text_attr, cfg: ExcelConfig,
                 mode: str = "training_free", batch_size: int = 4,
                 resize: int | None = None, progress=None, save_cam=None,
                 save_lam_crf=None, crf_tpu: bool = False,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 100, device="cuda"):
    """LAM pseudo-label sweep -> scores dict.

    dataset: len() and [i] -> {"name", "image" uint8 [h,w,3], "label" int
    [h,w], "cls_label" [num_fg]}. params and text_attr must already be on
    `device`. progress(n) is called after each batch with its sample count
    (remainder padding included).
    save_cam(name, image_u8 [h,w,3], cams [1+C_fg,h,w]) optionally receives
    each image's normed pre-PAR per-class maps (the full class stack).
    save_lam_crf(name, valid_lam [1+K,h,w], keys [K])
    receives the spill of the host CRF pass: bg + the image's K
    present-class normed cams and their 0-based fg indices (ascending).
    crf_tpu=True additionally runs the on-device conv mean-field CRF branch
    (`lam_crf_refine`) and returns (scores, crf_scores).
    checkpoint_path: periodic hist + progress checkpoint (about every
    `checkpoint_every` images) that a rerun with the same protocol resumes
    from; off with dumps or the CRF branch (the files of skipped batches
    and the second hist would be missing)."""
    device = resolve_device(device)
    resize = resize or cfg.clip.image_size
    fp = (f"lam:sg1:{len(dataset)}:{batch_size}:{mode}:{resize}:"
          f"{cfg.num_classes}:{cfg.data.eval_pad}:proc{rank()}/{world()}")
    checkpoint_path = _rank_path(checkpoint_path)
    dumps = save_cam is not None or save_lam_crf is not None
    if dumps or crf_tpu:
        checkpoint_path = None
    hist, start = _sweep_resume(checkpoint_path, fp, cfg.num_classes, device)
    crf_hist = init_hist(cfg.num_classes, device) if crf_tpu else None
    n_done = start * batch_size
    last_saved = n_done
    # slot-homogeneous batches, except for save_cam sweeps, which run the
    # full class stack (crf spills keep the slot compaction: the compacted
    # stack is the spill format)
    sb = None if save_cam is not None else cfg.refine.slot_buckets
    prepped = prefetch_iter(
        (cv, b, _prep_batch(b, resize, cv, with_canvas_images=crf_tpu))
        for cv, b in _skip_batches(
            _bucketed_batches(dataset, batch_size, cfg.data.eval_pad,
                              slot_buckets=sb, num_fg=cfg.num_fg),
            start))
    for canvas, samples, prep in prepped:
        slots = None if save_cam is not None else _slots_bucket(
            prep[1], cfg.num_fg, cfg.refine.slot_buckets)
        if profiling.enabled():
            _count_batch(samples, prep, canvas, cfg.num_fg, slots)
        with profiling.span("batch", batch=n_done // batch_size,
                            images=len(samples)):
            images, cls, labels, valid, *canvas_imgs = _to_device(prep,
                                                                 device)
            if not dumps and not crf_tpu:
                hist = lam_eval_hist_step(hist, params, images, cls, labels,
                                          valid, text_attr, cfg, canvas,
                                          mode, class_slots=slots)
            elif not dumps:
                hist, crf_hist = lam_crf_hist_step(
                    hist, crf_hist, params, images, cls, labels, valid,
                    canvas_imgs[0], text_attr, cfg, canvas, mode,
                    class_slots=slots)
            else:
                hist, crf_hist = _dump_batch(
                    hist, crf_hist, params, samples, images, cls, labels,
                    valid, canvas_imgs, text_attr, cfg, canvas, mode, slots,
                    crf_tpu, save_cam, save_lam_crf)
        n_done += len(samples)
        if checkpoint_path and n_done - last_saved >= checkpoint_every:
            _sweep_save(checkpoint_path, hist, n_done // batch_size, fp)
            last_saved = n_done
        if progress:
            progress(len(samples))
    _sweep_done(checkpoint_path)
    if crf_tpu:
        return (scores_from_hist(global_sum_host(hist)),
                scores_from_hist(global_sum_host(crf_hist)))
    return scores_from_hist(global_sum_host(hist))


def run_validation(params: dict, dataset, text_attr, cfg: ExcelConfig,
                   batch_size: int = 4, progress=None, device="cuda"):
    """In-training validation sweep -> (pseudo-label scores, seg scores).
    params (clip and head) and text_attr must already be on `device`;
    progress(n) is called after each batch with its sample count."""
    device = resolve_device(device)
    hist_p = init_hist(cfg.num_classes, device)
    hist_s = init_hist(cfg.num_classes, device)
    sb = cfg.refine.slot_buckets
    prepped = prefetch_iter(
        (cv, b, _prep_batch(b, cfg.clip.image_size, cv))
        for cv, b in _bucketed_batches(dataset, batch_size, cfg.data.eval_pad,
                                       slot_buckets=sb, num_fg=cfg.num_fg))
    for canvas, samples, (images, cls, labels, valid) in prepped:
        slots = _slots_bucket(cls, cfg.num_fg, sb)
        images, cls, labels, valid = _to_device(
            (images, cls, labels, valid), device)
        hist_p, hist_s = val_hist_step(hist_p, hist_s, params, images, cls,
                                       labels, valid, text_attr, cfg, canvas,
                                       class_slots=slots)
        if progress:
            progress(len(samples))
    return (scores_from_hist(global_sum_host(hist_p)),
            scores_from_hist(global_sum_host(hist_s)))


def run_msc_seg_eval(params: dict, dataset, text_attr, cfg: ExcelConfig,
                     scales=(1.0, 0.7, 1.2, 1.5), batch_size: int = 4,
                     resize: int | None = None, progress=None,
                     save_logits=None, save_pred=None, crf_tpu: bool = False,
                     checkpoint_path: str | None = None,
                     checkpoint_every: int = 100, device="cuda"):
    """MSC+flip segmentation sweep -> scores dict. params (clip and head)
    and text_attr must already be on `device`; progress(n) is called after
    each batch with its sample count.

    save_logits(name, logits [C, h, w]) / save_pred(name, label [h, w])
    optionally receive per-image outputs: the fused pre-CRF logits, averaged
    over the scales, and the prediction. crf_tpu=True runs the on-device
    convolutional mean-field CRF (ops/crf_tpu.py) on the fused logits before
    the argmax. checkpoint_path: periodic hist + progress checkpoint that a
    rerun with the same protocol (the CRF's parameters included) resumes
    from; off when per-image dumps are requested (their files would be
    missing on resume)."""
    device = resolve_device(device)
    base = resize or cfg.clip.image_size
    # a resumed hist must not blend predictions of different CRF settings
    crf_fp = f"{cfg.crf}" if crf_tpu else ""
    fp = (f"msc:{len(dataset)}:{batch_size}:{base}:{scales}:{crf_tpu}:"
          f"{crf_fp}:{cfg.num_classes}:{cfg.data.eval_pad}"
          f":proc{rank()}/{world()}")
    checkpoint_path = _rank_path(checkpoint_path)
    want_dumps = save_logits is not None or save_pred is not None
    if want_dumps:
        checkpoint_path = None
    hist, start = _sweep_resume(checkpoint_path, fp, cfg.num_classes, device)
    n_done = start * batch_size
    last_saved = n_done
    cfgs = _scale_cfgs(cfg, base, scales)
    prepped = prefetch_iter(
        (cv, b, *_prep_msc_batch(b, base, cv, scales,
                                 with_canvas_images=crf_tpu))
        for cv, b in _skip_batches(
            _bucketed_batches(dataset, batch_size, cfg.data.eval_pad),
            start))
    for canvas, samples, prep, scale_images in prepped:
        if profiling.enabled():
            _count_batch(samples)
        with profiling.span("batch", batch=n_done // batch_size,
                            images=len(samples)):
            labels, valid, *canvas_imgs = _to_device(prep[2:], device)
            out = msc_hist_step(
                hist, params, _to_device(scale_images, device), labels,
                valid, text_attr, cfgs, canvas,
                tuple(sc != 1.0 for sc in scales),
                canvas_images=canvas_imgs[0] if crf_tpu else None,
                use_crf=crf_tpu, return_outputs=want_dumps)
            if want_dumps:
                hist, logits, preds = out
                logits_np = logits.cpu().numpy()
                preds_np = preds.cpu().numpy()
                for i, s in enumerate(samples):
                    if s.get("_pad"):   # remainder padding: no files
                        continue
                    h, w = s["label"].shape
                    if save_logits:
                        save_logits(s["name"],
                                    logits_np[i, :, :h, :w] / len(scales))
                    if save_pred:
                        save_pred(s["name"], preds_np[i, :h, :w])
            else:
                hist = out
        n_done += len(samples)
        if checkpoint_path and n_done - last_saved >= checkpoint_every:
            _sweep_save(checkpoint_path, hist, n_done // batch_size, fp)
            last_saved = n_done
        if progress:
            progress(len(samples))
    _sweep_done(checkpoint_path)
    return scores_from_hist(global_sum_host(hist))
