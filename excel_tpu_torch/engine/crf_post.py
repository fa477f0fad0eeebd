"""The host dense CRF over a whole dataset (counterpart of
excel_tpu/engine/crf_post.py).

The reference's protocol (tools/infer_seg_voc.py:90-91,103-174,
tools/infer_seg_coco.py:91-92,100-167, tools/infer_lam.py:116-120,179-237):
the sweep spills one npy an image, a pickled dict of the pre-CRF arrays,
and a host pass streams the files back through the lattice CRF, takes the
argmax and scores it against the full-resolution ground truth. The spill
format is the JAX package's, so each package reads the other's files.

- Memory is bounded: at most 2 x workers images are in flight, and each
  finished image folds into the [C, C] confusion hist at once.
- Threads, not processes: the lattice call releases the interpreter lock.
  The pool is 0.6 x cpu_count wide, the reference's joblib sizing
  (tools/infer_seg_voc.py:164-165).
- Decoding the image and its label happens inside the pooled job.

The returned hist is the process's own, over the dataset it was given: a
rank of a process group passes its shard, and the eval CLIs sum the ranks'
hists (`parallel.distributed.global_sum_host`) before scoring them.
"""
from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..crf import DenseCRF
from ..data.resize import resize_bilinear
from ..utils.metrics import update_hist_np


def default_workers() -> int:
    """The reference's joblib pool sizing (tools/infer_seg_voc.py:164)."""
    return max(1, int((os.cpu_count() or 1) * 0.6))


def crf_from_cfg(crf_cfg) -> DenseCRF:
    """The eval protocol's parameter set (tools/infer_seg_voc.py:113-120 ==
    tools/infer_lam.py:189-196: both CRF passes share it)."""
    return DenseCRF(iter_max=crf_cfg.iters, pos_w=crf_cfg.pos_w,
                    pos_xy_std=crf_cfg.pos_xy_std, bi_w=crf_cfg.bi_w,
                    bi_xy_std=crf_cfg.bi_xy_std, bi_rgb_std=crf_cfg.bi_rgb_std)


# ---------------------------------------------------------------------------
# the sweeps' spillers (their save_logits / save_lam_crf hooks)
# ---------------------------------------------------------------------------

def seg_logit_spiller(logits_dir: str, scale: float = 1.0):
    """-> save_logits(name, logits [C, h, w]) writing the reference's
    per-image npy dict {"msc_seg": [1, C, h, w]} (infer_seg_voc.py:90-91),
    fp32.

    scale < 1 stores downscaled logits: the reference's COCO disk bound
    (infer_seg_coco.py:62-64 saves at 0.2 x label resolution; its CRF pass
    upsamples bilinearly before the softmax)."""
    os.makedirs(logits_dir, exist_ok=True)

    def save(name: str, logits: np.ndarray) -> None:
        if scale != 1.0:
            c, h, w = logits.shape
            oh, ow = max(1, int(scale * h)), max(1, int(scale * w))
            logits = resize_bilinear(
                np.transpose(logits, (1, 2, 0)), (oh, ow)).transpose(2, 0, 1)
        np.save(os.path.join(logits_dir, name + ".npy"),
                {"msc_seg": np.asarray(logits, np.float32)[None]})

    return save


def lam_spiller(logits_dir: str):
    """-> save(name, valid_lam [1+K, h, w], keys [K]) writing the
    reference's LAM spill {"valid_lam", "keys_gt"} (infer_lam.py:116-119):
    background and the image's K present-class normed cams, and their
    0-based foreground class indices."""
    os.makedirs(logits_dir, exist_ok=True)

    def save(name: str, valid_lam: np.ndarray, keys: np.ndarray) -> None:
        np.save(os.path.join(logits_dir, name + ".npy"),
                {"valid_lam": np.asarray(valid_lam, np.float32),
                 "keys_gt": np.asarray(keys, np.int64)})

    return save


# ---------------------------------------------------------------------------
# the streaming post-pass
# ---------------------------------------------------------------------------

def _make_job(dataset, logits_dir: str, crf, kind: str, save_pred):
    """-> one(i): read dataset[i] and its spilled npy, run the CRF, return
    (name, pred, label): the per-image work of the reference's jobs
    (tools/infer_seg_voc.py:131-162, infer_seg_coco.py:121-157,
    infer_lam.py:198-225)."""
    if kind not in ("seg", "lam"):
        raise ValueError(f"crf_post kind {kind!r}: 'seg' or 'lam'")

    def one(i: int):
        s = dataset[i]
        name = s["name"]
        # the files are this program's own spills (or the JAX package's)
        d = np.load(os.path.join(logits_dir, name + ".npy"),
                    allow_pickle=True).item()
        image = np.ascontiguousarray(s["image"], np.uint8)
        h, w = image.shape[:2]
        if kind == "seg":
            logits = np.asarray(d["msc_seg"], np.float32)[0]
            if logits.shape[1:] != (h, w):
                logits = resize_bilinear(
                    np.transpose(logits, (1, 2, 0)), (h, w)).transpose(
                    2, 0, 1)
            x = logits - logits.max(0, keepdims=True)
            np.exp(x, out=x)
            x /= x.sum(0, keepdims=True)
            prob = crf(image, np.ascontiguousarray(x))
            pred = prob.argmax(0).astype(np.int32)
        else:
            lam = np.ascontiguousarray(d["valid_lam"], np.float32)
            keys = np.asarray(d["keys_gt"], np.int64)
            slot = crf(image, lam).argmax(0)
            # slot 0 is the background; slot k is class keys[k - 1] + 1
            full_keys = np.pad(keys + 1, (1, 0), mode="constant")
            pred = full_keys[slot].astype(np.int32)
        if save_pred is not None:
            save_pred(name, pred)
        return name, pred, np.asarray(s["label"])

    return one


def _stream_pool(n_jobs: int, fn, workers: int):
    """Run fn(0..n-1) on `workers` threads, yielding the results in order
    with at most 2 x workers jobs in flight (the memory bound)."""
    inflight = 2 * workers
    with ThreadPoolExecutor(max_workers=workers) as pool:
        q: deque = deque()
        for i in range(n_jobs):
            q.append(pool.submit(fn, i))
            if len(q) >= inflight:
                yield q.popleft().result()
        while q:
            yield q.popleft().result()


def run_crf_post(dataset, logits_dir: str, crf: DenseCRF, num_classes: int,
                 kind: str = "seg", num_workers: int | None = None,
                 save_pred=None, progress=None) -> np.ndarray:
    """Stream `dataset`'s spilled npy files through the dense CRF; return
    the [C, C] int64 confusion hist.

    kind="seg" (infer_seg_voc.py:131-162): {"msc_seg"}, upsampled
    bilinearly to the image's size if spilled downscaled (resize before the
    softmax, infer_seg_coco.py:143-145), softmax over classes, CRF, argmax.
    kind="lam" (infer_lam.py:198-225): {"valid_lam", "keys_gt"}, the normed
    cams as the unary probabilities (no softmax), CRF, argmax, slots mapped
    back through the keys.

    save_pred(name, pred [H, W] int32) optionally keeps each refined map.
    dataset[i] yields {"name", "image" uint8 [H, W, 3], "label" [H, W]}."""
    one = _make_job(dataset, logits_dir, crf, kind, save_pred)
    workers = num_workers or default_workers()
    hist = np.zeros((num_classes, num_classes), np.int64)
    for _, pred, label in _stream_pool(len(dataset), one, workers):
        update_hist_np(hist, label, pred, num_classes)
        if progress:
            progress(1)
    return hist


class StreamingCrfPost:
    """The host CRF overlapped with the device sweep.

    `run_crf_post` runs the lattice after the whole sweep, so the run takes
    sweep + CRF. Submitting each image from the sweep's spill hook lets the
    pool work while the card computes the next batches: about
    max(sweep, CRF) on a host with cores to spare. The result is the
    post-pass's: the per-image work is `_make_job`'s.

        post = StreamingCrfPost(dataset, logits_dir, crf, C, kind="seg")
        spill = seg_logit_spiller(logits_dir)
        run_msc_seg_eval(..., save_logits=lambda n, l: (spill(n, l),
                                                        post.submit(n)))
        hist = post.finish()

    Finished images fold into the hist as they complete; a job not yet
    started holds only an index."""

    def __init__(self, dataset, logits_dir: str, crf, num_classes: int,
                 kind: str = "seg", num_workers: int | None = None,
                 save_pred=None):
        self._one = _make_job(dataset, logits_dir, crf, kind, save_pred)
        self._by_name = {n: i for i, n in enumerate(dataset.names())}
        self._pool = ThreadPoolExecutor(
            max_workers=num_workers or default_workers())
        self._futures: deque = deque()
        self._hist = np.zeros((num_classes, num_classes), np.int64)

    def _drain(self, block: bool) -> None:
        while self._futures and (block or self._futures[0].done()):
            _, pred, label = self._futures.popleft().result()
            update_hist_np(self._hist, label, pred, self._hist.shape[0])

    def submit(self, name: str) -> None:
        self._futures.append(self._pool.submit(self._one,
                                               self._by_name[name]))
        self._drain(block=False)

    def finish(self) -> np.ndarray:
        """Drain every job, shut the pool down, return the hist."""
        self._drain(block=True)
        self._pool.shutdown()
        return self._hist
