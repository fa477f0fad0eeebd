"""What the eval-sweep drivers share: the pool as the program's dataset,
an endless stream over it, the warm-up batches, and the capture of the
program's per-image outputs for the check."""
from __future__ import annotations

import time

import numpy as np

from . import traffic as T
from .seeds import sub_seed


class WindowClosed(Exception):
    """Raised from the sweep's progress callback when the window is over."""


def timed_sweep(ctx, sweep):
    """Run sweep(progress) over the endless stream inside the window: the
    program calls progress(n) after each batch it enqueues, and the first
    call past the window's seconds ends the sweep. Returns (setup_s,
    window_s, images, the window), the wrappers restored."""
    from .context import Window

    win = Window(ctx)
    done = [0]

    def progress(n):
        done[0] += n
        if win.tick():
            raise WindowClosed

    setup_s = time.perf_counter() - ctx.t_process
    win.open()
    try:
        sweep(progress)
        raise RuntimeError("the endless stream ended")
    except WindowClosed:
        pass
    window_s = win.close()
    ctx.spans.restore()
    return setup_s, window_s, done[0], win


def dataset(ctx, pool):
    """Write the pool's tree under the run's scratch dir and open it with
    the program's readers (data/datasets): an EvalDataset."""
    from excel_tpu_torch.data import datasets

    mix = ctx.traffic
    split_dir = T.write_tree(pool, mix, ctx.workdir)
    kind = datasets.CocoDataset if mix["layout"] == "coco" \
        else datasets.VocDataset
    base = kind(ctx.workdir, split_dir, mix["split"], stage="val")
    base.num_fg = ctx.cfg.num_fg
    return datasets.EvalDataset(base)


class Stream:
    """The pool's dataset cycled without end in a seeded order; each read
    (the program's reader: decode and labels) is timed as span "read"."""

    def __init__(self, ds, spans, seed: int):
        self.ds = ds
        self.spans = spans
        self.order = np.random.default_rng(
            sub_seed(seed, "order")).permutation(len(ds))

    def __len__(self):
        return 1 << 40

    def __getitem__(self, i):
        t0 = time.perf_counter()
        s = self.ds[int(self.order[i % len(self.order)])]
        self.spans.durations["read"].append(time.perf_counter() - t0)
        return s


def warm_samples(ds, batch: int, pad: int, slot_buckets, num_fg: int):
    """One batch for every (canvas, most classes) the pool's batches take,
    grouped as the program groups a sweep (evaluate._bucketed_batches over
    as many copies of the pool as a batch holds, so that every group
    fills): the warm-up sweep's samples."""
    from excel_tpu_torch.engine import evaluate

    samples = [ds[i] for i in range(len(ds))]
    seen, out = set(), []
    batches = evaluate._bucketed_batches(samples * batch, batch, pad,
                                         slot_buckets=slot_buckets,
                                         num_fg=num_fg)
    for canvas, group in batches:
        most = max(int((np.asarray(s["cls_label"]) > 0).sum())
                   for s in group) if slot_buckets is not None else 0
        key = (tuple(canvas), most)
        if key not in seen and not any(s.get("_pad") for s in group):
            seen.add(key)
            out.extend(group)
    return out


class Capture:
    """Per pool image, its first outputs in the window: tensors cloned on
    the device (small crops of each batch's outputs), keyed by pool
    index. An output that never came (a batch's tensor short of the
    image's row) stays missing, and `missing` counts it."""

    def __init__(self, pool):
        self.index = {s["name"]: i for i, s in enumerate(pool)}
        self.hw = [s["label"].shape for s in pool]
        self.names: list = []          # per prepared batch, its names
        self.batch = -1
        self.pending: list = []        # [(row, pool index)] of this batch
        self.out: dict = {}            # pool index -> {key: tensor}

    def prepared(self, samples) -> None:
        self.names.append([s["name"] for s in samples])

    def next_batch(self) -> None:
        self.batch += 1
        self.pending = [(r, self.index[n])
                        for r, n in enumerate(self.names[self.batch])
                        if self.index[n] not in self.out]
        for _, i in self.pending:
            self.out[i] = {}

    def take(self, key: str, tensor, crop: bool = False, dtype=None,
             pick=None) -> None:
        """Keep row r of `tensor` for each pending image: cropped to its
        extent, converted to `dtype`, or reduced by pick(pool index, row)."""
        for row, i in self.pending:
            if row >= len(tensor):
                continue
            t = tensor[row]
            if crop:
                h, w = self.hw[i]
                t = t[..., :h, :w]
            if pick is not None:
                t = pick(i, t)
            self.out[i][key] = t.to(dtype) if dtype is not None \
                else t.clone()


def missing(cap, keys) -> int:
    """Outputs the window's images should have and lack."""
    return sum(k not in got for got in cap.out.values() for k in keys)
