"""Training driver of the LVC head on the GPU (counterpart of
excel_tpu/cli/train.py).

    python -m excel_tpu_torch.cli.train --dataset voc \
        --data-root /data/VOC2012 --clip-params clip_vit_b16.npz --fast

One driver covers both datasets (presets in excel_tpu_torch.config); the
schedule's phase thresholds (`lvc_calibrate_iter`, `seg_affinity_iter`)
pick one of three specialisations of the train step, and the class-slot
bucket of each batch another (engine/train.TrainStepCache). The batches
come from the seeded, Pillow-free crop pipeline (data/loader.train_batches
over data/datasets.ClsCropDataset), staged to the device through pinned
memory. The step returns its losses as device scalars: the loop sums them
on the device and reads them only every `log_iters`. Every `eval_iters`
(and at the end) it writes a checkpoint and the head's `.npz`, then runs
the in-training validation, with TensorBoard scalars and image grids
(`--tensorboard`) and image / pseudo-label / segmentation panels as PNG
files (`--viz`; the JAX package writes JPEGs through Pillow).

`--resume` restarts from the latest checkpoint's step with the batch
stream at its first batch, as the JAX package's driver does: a resumed run
does not see the batches an unbroken run would.

Data parallel over N devices: one process a device, started by torchrun,

    torchrun --nproc_per_node N -m excel_tpu_torch.cli.train ...

(`--dist-backend gloo --device cuda:0` for ranks that share one card).
`--batch-size` is per rank: the global batch is batch_size x N, each rank
feeds its loader shard (rows [r*B, (r+1)*B) of the global batch), takes
the full-class-stack step (`TrainStepCache.full`, the same program on
every rank) and holds the same head after each step (engine/train). The
logged losses are the global batch's, summed over the ranks when they are
logged. Validation runs on every rank over its round-robin shard of the
val set, with the hists summed over the ranks. Rank 0 alone writes the
log file, the checkpoints, the head files, the TensorBoard events and the
panels; every rank logs to its console.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from ..data.loader import train_batches
from ..engine.checkpoint import (latest_checkpoint, restore_checkpoint,
                                 save_checkpoint, save_head_npz)
from ..engine.evaluate import _to_device, run_validation
from ..engine.train import (TrainStepCache, _phase, init_train_state,
                            step_generator)
from ..models.excel import init_excel_params
from ..parallel import is_primary, replicate
from ..parallel.distributed import group_sum, rank, shard_dataset, world
from ..utils.logutils import AverageMeter, Eta, setup_logger
from ..utils.metrics import format_metrics_table
from .common import (add_common_args, eval_dataset, resolve, score_names,
                     train_dataset)

# the logged metrics that the step returns on the device (the rate is a
# host float)
DEVICE_METRICS = ("seg_loss", "diver_loss")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(ap)
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--eval-iters", type=int, default=None)
    ap.add_argument("--log-iters", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-eval", action="store_true")
    ap.add_argument("--viz", action="store_true",
                    help="write image/pseudo/seg colormap panels as PNG at "
                         "each eval")
    ap.add_argument("--tensorboard", action="store_true",
                    help="write TensorBoard scalars (lr/losses/val mIoU) and "
                         "image grids under work_dir/tb")
    ap.add_argument("--num-workers", type=int, default=None,
                    help="decode/augment worker threads (default: "
                         "min(10, cpu_count))")
    args = ap.parse_args(argv)

    cfg, clip_params, text_attr = resolve(args)
    device = text_attr.device
    os.makedirs(args.work_dir, exist_ok=True)
    logger = setup_logger(os.path.join(args.work_dir, "train.log")
                          if is_primary() else None)
    overrides = {k: getattr(args, k) for k in
                 ("max_iters", "eval_iters", "log_iters") if getattr(args, k)}
    if overrides:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **overrides))
    batch_size = args.batch_size or cfg.train.batch_size
    logger.info("device: %s (rank %d of %d, global batch %d)", device,
                rank(), world(), batch_size * world())
    logger.info("config: %s", cfg)

    params = init_excel_params(
        cfg, clip_params, torch.Generator().manual_seed(cfg.train.seed),
        device)
    state = init_train_state(params["head"], cfg.train)
    ckpt_dir = os.path.join(args.work_dir, "checkpoints")
    if args.resume:
        latest = latest_checkpoint(ckpt_dir)
        if latest:
            state = restore_checkpoint(latest, state)
            logger.info("resumed from %s (step %d)", latest, state.step)
    replicate(state.head, state.optimizer)

    dataset = train_dataset(cfg)
    val_ds = None if args.no_eval else shard_dataset(eval_dataset(cfg))
    logger.info("train samples: %d", len(dataset))
    workers = args.num_workers
    if workers is None:
        workers = min(10, os.cpu_count() or 1)
    batches = train_batches(dataset, batch_size, seed=cfg.train.seed,
                            num_workers=workers, process_index=rank(),
                            process_count=world())

    tb = None
    if args.tensorboard and is_primary():
        from ..utils.tb import SummaryWriter
        tb = SummaryWriter(os.path.join(args.work_dir, "tb"))
    try:
        _train_loop(args, cfg, state, clip_params, text_attr, batches,
                    val_ds, tb, batch_size, logger, ckpt_dir, device)
    finally:
        batches.close()
        if tb is not None:
            tb.close()
    logger.info("done: %d iters", cfg.train.max_iters)
    return state


def _train_loop(args, cfg, state, clip_params, text_attr, batches, val_ds,
                tb, batch_size, logger, ckpt_dir, device):
    steps = TrainStepCache(cfg)
    names = score_names(cfg)
    start = state.step
    meter, eta = AverageMeter(), Eta(cfg.train.max_iters)
    # per device metric: the float64 sum of the window's values (the
    # meter's own sum, taken on the device) and their count
    sums: dict = {}
    count = 0
    for n_iter in range(start, cfg.train.max_iters):
        batch = next(batches)
        phase = _phase(cfg, n_iter)
        step_fn = (steps.full(phase) if world() > 1
                   else steps(phase, batch["cls_label"]))
        images, cls = _to_device((batch["image"], batch["cls_label"]),
                                 device)
        state, metrics = step_fn(
            state, clip_params, images, cls, text_attr,
            step_generator(cfg.train, n_iter, device))
        for k in DEVICE_METRICS:
            v = metrics[k].double()
            sums[k] = v if k not in sums else sums[k] + v
        count += 1
        meter.add({"lr": metrics["lr"]})

        it = n_iter + 1
        if it % cfg.train.log_iters == 0:
            elapsed, remaining = eta(it - start)
            # each rank's losses are its shares of the global batch's
            means = dict(zip(DEVICE_METRICS, (group_sum(
                torch.stack([sums[k] for k in DEVICE_METRICS])).cpu()
                / count).tolist()))
            sums.clear()
            count = 0
            lr = meter.pop("lr")
            logger.info(
                "Iter: %d; Elapsed: %s; ETA: %s; LR: %.3e; "
                "seg_loss: %.4f, diver_loss: %.4f", it, elapsed, remaining,
                lr, means["seg_loss"], means["diver_loss"])
            if tb is not None:
                tb.add_scalar("train/lr", lr, it)
                tb.add_scalar("train/seg_loss", means["seg_loss"], it)
                tb.add_scalar("train/diver_loss", means["diver_loss"], it)
        if it % cfg.train.eval_iters == 0 or it == cfg.train.max_iters:
            path = save_checkpoint(ckpt_dir, state)
            save_head_npz(os.path.join(args.work_dir, f"head_{it}.npz"),
                          state.head)
            if is_primary():
                logger.info("checkpoint: %s", path)
            if val_ds is None:
                continue
            eval_params = {"clip": clip_params, "head": state.head}
            pseudo, seg = run_validation(eval_params, val_ds, text_attr, cfg,
                                         batch_size=batch_size, device=device)
            if not is_primary():
                continue
            logger.info("val @%d:\n[pseudo]\n%s\n[seg]\n%s", it,
                        format_metrics_table(pseudo, names),
                        format_metrics_table(seg, names))
            if tb is not None:
                tb.add_scalar("val/pseudo_miou", pseudo["miou"], it)
                tb.add_scalar("val/seg_miou", seg["miou"], it)
            if args.viz or tb is not None:
                _dump_viz(args.work_dir, it, eval_params, val_ds, text_attr,
                          cfg, batch_size, device, tb=tb, save_png=args.viz)


def _dump_viz(work_dir, it, params, val_ds, text_attr, cfg, batch_size,
              device, tb=None, save_png=True):
    """Side-by-side image / pseudo-label / seg panels of the first val
    batch, as PNG files and/or TensorBoard images."""
    from ..data.png import write_png
    from ..engine.evaluate import _batched, _prep_batch, val_step
    from ..utils.visual import encode_cmap

    viz_dir = os.path.join(work_dir, "viz")
    os.makedirs(viz_dir, exist_ok=True)
    canvas = (cfg.data.eval_pad, cfg.data.eval_pad)
    samples = next(iter(_batched(val_ds, min(batch_size, 4))))
    images, cls, _, valid = _prep_batch(samples, cfg.clip.image_size, canvas)
    images, cls, valid = _to_device((images, cls, valid), device)
    pseudos, segs = val_step(params, images, cls, valid, text_attr, cfg,
                             canvas)
    pseudos, segs = pseudos.cpu().numpy(), segs.cpu().numpy()
    for i, s in enumerate(samples):
        h, w = s["label"].shape
        panel = np.concatenate([
            s["image"][:h, :w],
            encode_cmap(pseudos[i, :h, :w]),
            encode_cmap(segs[i, :h, :w]),
        ], axis=1)
        if save_png:
            write_png(os.path.join(viz_dir, f"iter{it}_{s['name']}.png"),
                      panel)
        if tb is not None:
            tb.add_image(f"val/{s['name']}", panel, it, dataformats="HWC")


if __name__ == "__main__":
    main()
