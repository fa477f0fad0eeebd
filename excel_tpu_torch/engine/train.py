"""Training of the LVC head (counterpart of excel_tpu/engine/train.py).

One step: normalise the uint8 crops, run the frozen encoder (no autograd)
and the head (autograd), the LVC-calibrated second encoder pass in the
calibrated phases, the crop-resolution pseudo-labels (SVC, PAR), the seg
and diversity losses, backward through the head only, and one optimizer
update. The phase switches (`lvc_calibrate_iter`, `seg_affinity_iter`)
pick one of three specialisations per step, as in the JAX package.

Differences of form from the JAX package, none of them numeric:
- The state is mutable: `train_step` updates the head and the optimizer in
  place, increments `state.step` and returns the same state.
- optax's `adamw` decays every head parameter, biases and LayerNorm
  scales included: here a `torch.optim.AdamW` with one parameter group
  (eps 1e-8); `poly_sgd` is `torch.optim.SGD(momentum=0.9,
  weight_decay=wd)`, which is optax's `chain(add_decayed_weights, sgd)`.
- The learning rate of each update is `lr_schedule(step)` of the step
  before the update, set on the group by hand (optax's count semantics;
  no LR scheduler object).
- Dropout draws come from a `torch.Generator` seeded from
  (cfg.train.seed, step) (`step_generator`); JAX's PRNGKey stream cannot be
  reproduced, so the parity tests run with dropout off.

Data parallel (one process a device, parallel/): the JAX step runs on a
mesh over every process, where its losses, attn_pred's mean and the LVC
calibration's mean are global reductions. Under a process group each rank
feeds its rows of the global batch and the step takes those reductions
over the group (models/losses' divisors and the head's dropout draw
always, the two means through excel_forward's `global_batch`), so that
each rank's loss is its share of the global loss, and after the backward
one all_reduce sums the head's gradients: the sum, not a mean, since the
shares already sum to the global loss. Every rank then takes the same
AdamW update. Without a group the step is the single-process one,
collective-free.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from ..config import ExcelConfig, TrainConfig
from ..models.excel import excel_forward
from ..models.head import LvcHead
from ..models.losses import aff_loss, seg_loss
from ..ops.labels import affinity_label, radius_mask, upsample_linear
from ..ops.par import fill_counts
from ..utils import profiling
from .pipeline import (attn_mode_for, denormalize_images, normalize_images,
                       pseudo_labels)


@dataclasses.dataclass
class TrainState:
    step: int
    head: LvcHead
    optimizer: torch.optim.Optimizer


def lr_schedule(cfg: TrainConfig):
    """step -> learning rate (the reference's multipliers on the 10x head
    LR), in float32 as the JAX package computes it:
    - poly:     linear warmup from warmup_ratio, then (1 - t/T)^power;
    - cos:      linear warmup, then 0.5 + 0.5 cos(pi (t - W) / (T - W));
    - poly_sgd: the reference's decreasing warmup 10 (1 - t/W)^power, then
                poly over the remaining steps."""
    f = np.float32
    base = f(cfg.lr * 10.0)
    w, t_max, power = f(cfg.warmup_iters), f(cfg.max_iters), f(cfg.power)
    ratio = f(cfg.warmup_ratio)

    def sched(step: int) -> float:
        t = f(step)
        if cfg.schedule == "cos":
            warm = t / w + (f(1.0) - t / w) * ratio
            rest = (f(np.cos((t - w) / (t_max - w) * f(np.pi))) * f(0.5)
                    + f(0.5))
        elif cfg.schedule == "poly_sgd":
            warm = f(10.0) * max(f(1.0) - t / w, f(0.0)) ** power
            rest = max(f(1.0) - (t - w) / (t_max - w), f(0.0)) ** power
        else:
            warm = ratio + f(1.0 - cfg.warmup_ratio) * t / w
            rest = max(f(1.0) - t / t_max, f(0.0)) ** power
        return float(base * (warm if t < w else rest))

    return sched


def make_optimizer(head: LvcHead, cfg: TrainConfig) -> torch.optim.Optimizer:
    """AdamW (eps 1e-8, the config's betas and weight decay) or, for
    poly_sgd, SGD with momentum 0.9; one group over every head
    parameter. The group's lr is set per step by `train_step`."""
    params = list(head.parameters())
    lr0 = lr_schedule(cfg)(0)
    if cfg.schedule == "poly_sgd":
        return torch.optim.SGD(params, lr=lr0, momentum=0.9,
                               weight_decay=cfg.weight_decay)
    return torch.optim.AdamW(params, lr=lr0, betas=tuple(cfg.betas), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def init_train_state(head: LvcHead, cfg: TrainConfig) -> TrainState:
    return TrainState(step=0, head=head, optimizer=make_optimizer(head, cfg))


def step_generator(cfg: TrainConfig, step: int, device) -> torch.Generator:
    """The dropout generator of one step, seeded from (seed, step)."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed((int(cfg.seed) << 32) + int(step))
    return g


def _phase(cfg: ExcelConfig, step: int) -> tuple[bool, bool]:
    """(lvc_calibrated, seg_affinity) of a step."""
    return (step >= cfg.train.lvc_calibrate_iter,
            step >= cfg.train.seg_affinity_iter)


@functools.lru_cache(maxsize=8)
def _radius_mask_on(grid: int, radius: int,
                    device: torch.device) -> torch.Tensor:
    return torch.from_numpy(radius_mask(grid, grid, radius)).to(device)


def train_losses(head: LvcHead, clip_params: dict, images_u8: torch.Tensor,
                 cls_label: torch.Tensor, text_attr: torch.Tensor,
                 generator: torch.Generator | None, cfg: ExcelConfig, *,
                 calibrated: bool, seg_affinity: bool,
                 class_slots: int | None = None):
    """The forward of one training iteration: (total loss, seg loss,
    diversity loss, pseudo-labels [B, H, W] int32), the losses as 0-d
    tensors that autograd can take back to the head. Under a process group
    the losses are this rank's shares of the global batch's (module
    docstring)."""
    with profiling.span("forward"):
        images = normalize_images(images_u8)
        crop_hw = tuple(images.shape[1:3])
        grid = crop_hw[0] // cfg.clip.patch_size
        par_imgs = denormalize_images(images).permute(0, 3, 1, 2)
        mask = _radius_mask_on(grid, cfg.refine.radius, images.device)
        params = {"clip": clip_params, "head": head}

        out = excel_forward(params, images, text_attr, cfg,
                            dropout_generator=generator,
                            attn_mode="stack" if calibrated
                            else attn_mode_for(cfg), global_batch=True)
        lams = out.lams
        if calibrated:
            lams = excel_forward(params, images, text_attr, cfg,
                                 ex_feats=out.fused, global_batch=True)
        with profiling.span("pseudo"):
            pseudos = pseudo_labels(
                lams, out.attn_weights, par_imgs, cls_label, cfg, crop_hw,
                cfg.refine.caa_threshold,
                seg_attn=out.attn_pred.detach() if calibrated else None,
                class_slots=class_slots)

        with profiling.span("loss"):
            b, hw, c = out.segs.shape
            segs = upsample_linear(
                out.segs.transpose(1, 2).reshape(b, c, grid, grid), crop_hw)
            l_seg = seg_loss(segs, pseudos,
                             ignore_index=cfg.refine.ignore_index)
            aff_src = segs.detach().argmax(dim=1) if seg_affinity else pseudos
            aff_target = affinity_label(aff_src, mask=mask,
                                        ignore_index=cfg.refine.ignore_index,
                                        downscale=cfg.clip.patch_size)
            l_aff = aff_loss(out.attn_pred, aff_target)
            total = cfg.train.w_seg * l_seg + cfg.train.w_diver * l_aff
        return total, l_seg, l_aff, pseudos


def train_step(state: TrainState, clip_params: dict,
               images_u8: torch.Tensor, cls_label: torch.Tensor,
               text_attr: torch.Tensor,
               generator: torch.Generator | None, cfg: ExcelConfig, *,
               calibrated: bool, seg_affinity: bool,
               class_slots: int | None = None):
    """One training iteration on the device of its tensors.

    images_u8: [B, H, W, 3] uint8 crops; cls_label [B, num_fg] one-hot;
    generator: the head's dropout draws (None: no dropout); class_slots:
    refine only bg + this many present-class channels in the pseudo-label
    path. Returns (state, metrics): "loss", "seg_loss" and "diver_loss" as
    0-d tensors on the step's device, read by the caller only when it logs
    (a float here would wait for the device every step), and "lr", the
    float rate of this update; the state is updated in place. Under a
    process group the losses are the rank's shares (their sum over the
    ranks is the global batch's) and the update is every rank's."""
    profiling.count("steps")
    with profiling.span("step", images=images_u8.shape[0], step=state.step):
        total, l_seg, l_aff, _ = train_losses(
            state.head, clip_params, images_u8, cls_label, text_attr,
            generator, cfg, calibrated=calibrated, seg_affinity=seg_affinity,
            class_slots=class_slots)
        lr = lr_schedule(cfg.train)(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.zero_grad(set_to_none=True)
        with profiling.span("backward"):
            total.backward()
        if dist.is_initialized():
            _sum_gradients(list(state.head.parameters()))
        with profiling.span("optimizer"):
            state.optimizer.step()
    state.step += 1
    return state, {"loss": total.detach(), "seg_loss": l_seg.detach(),
                   "diver_loss": l_aff.detach(), "lr": lr}


def _sum_gradients(params: list) -> None:
    """The head's gradients summed over the process group, in one
    all_reduce of their concatenation (the JAX mesh's psum)."""
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    with profiling.span("allreduce"):
        dist.all_reduce(flat)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p))


def phased_train_steps(cfg: ExcelConfig) -> dict:
    """{(calibrated, seg_affinity): step function} for every phase the
    schedule reaches."""
    phases = {(False, False), _phase(cfg, cfg.train.lvc_calibrate_iter),
              _phase(cfg, max(cfg.train.seg_affinity_iter,
                              cfg.train.lvc_calibrate_iter))}
    return {p: functools.partial(train_step, cfg=cfg, calibrated=p[0],
                                 seg_affinity=p[1]) for p in sorted(phases)}


class TrainStepCache:
    """Step functions keyed by (phase, class-slot bucket): the bucket is the
    smallest of `buckets` (those below num_fg) that covers the batch's
    largest label cardinality, else the full class stack (None)."""

    def __init__(self, cfg: ExcelConfig, buckets: tuple[int, ...] = (4, 8)):
        self.cfg = cfg
        self.buckets = tuple(b for b in sorted(buckets) if b < cfg.num_fg)
        self._steps: dict = {}

    def slots_for(self, cls_batch) -> int | None:
        need = int((torch.as_tensor(cls_batch) > 0).sum(dim=1).max())
        return next((b for b in self.buckets if need <= b), None)

    def __call__(self, phase: tuple[bool, bool], cls_batch):
        slots = self.slots_for(cls_batch)
        if profiling.enabled():
            crop = self.cfg.data.crop_size
            cls = np.asarray(cls_batch)
            refined, useful = fill_counts(
                cls, [(crop, crop)] * len(cls), (crop, crop),
                1 + (self.cfg.num_fg if slots is None else slots))
            profiling.count("par.refined", refined)
            profiling.count("par.useful", useful)
        return self._step(phase, slots)

    def full(self, phase: tuple[bool, bool]):
        """The full-class-stack step (no slot compaction): the ranks of a
        group take it whatever their local batches' label cardinality, so
        that every rank runs the same program."""
        return self._step(phase, None)

    def _step(self, phase: tuple[bool, bool], slots: int | None):
        key = (*phase, slots)
        if key not in self._steps:
            self._steps[key] = functools.partial(
                train_step, cfg=self.cfg, calibrated=phase[0],
                seg_affinity=phase[1], class_slots=slots)
        return self._steps[key]
