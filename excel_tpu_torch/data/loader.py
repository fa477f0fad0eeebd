"""Batching and prefetch of the host pipeline (the port's copy of
excel_tpu/data/loader.py): the training batch stream and the eval sweeps'
samples and background prefetch.

Training batches come from an N-worker thread pool (numpy and the PNG
decoder's zlib release the GIL) as fixed-shape uint8 numpy batches, in
order; normalisation happens on the device. The index stream comes from
one seed-shared permutation sequence, and every sample's augmentation
generator is seeded from (seed, step, slot) rather than drawn from a
shared generator, so the stream is the same for any worker count and
equal to the JAX package's. Under a process group of N ranks, rank p takes
rows [p*B, (p+1)*B) of each global batch of B * N: the rows, and their
augmentations, that one process streaming the global batch would give.
"""
from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from ..utils import profiling


def _stack(samples: list[dict], keys: tuple[str, ...]) -> dict:
    out = {}
    for k in keys:
        vals = [s[k] for s in samples]
        out[k] = (np.stack(vals) if isinstance(vals[0], np.ndarray)
                  else np.asarray(vals)) if k != "name" else vals
    return out


def _index_stream(dataset_len: int, global_batch: int, seed: int):
    """Infinite deterministic stream of global-batch index lists: one
    permutation an epoch, leftover indices carried across the epoch
    boundary, so every batch is full even when the batch size does not
    divide (or exceeds) the dataset size."""
    rng = np.random.default_rng(seed)
    pool: list[int] = []
    while True:
        while len(pool) < global_batch:
            pool.extend(rng.permutation(dataset_len).tolist())
        idxs, pool[:] = pool[:global_batch], pool[global_batch:]
        yield idxs


# the sample fields a training batch carries, and the batches loaded ahead
# of the consumer beyond one a worker
BATCH_KEYS = ("name", "image", "cls_label", "img_box", "label")
PREFETCH = 2


def train_batches(dataset, batch_size: int, seed: int = 0,
                  num_workers: int = 1, process_index: int = 0,
                  process_count: int = 1) -> Iterator[dict]:
    """Infinite shuffled batch stream with an N-worker decode/augment pool.

    batch_size is per process; the global batch is batch_size *
    process_count and process p materialises rows [p*B, (p+1)*B) of it
    (the rank and world size of a process group). The stream is the same
    for every worker count."""
    gb = batch_size * process_count
    lo = process_index * batch_size

    def load_batch(step_idxs):
        step, idxs = step_idxs
        local = idxs[lo:lo + batch_size]
        samples = []
        for slot, i in enumerate(local):
            rng = np.random.default_rng((seed, step, lo + slot))
            samples.append(dataset.__getitem__(int(i), rng=rng))
        return _stack(samples, BATCH_KEYS)

    stream = enumerate(_index_stream(len(dataset), gb, seed))
    yield from _ordered_pool_map(load_batch, stream, max(1, num_workers),
                                 PREFETCH)


def _ordered_pool_map(fn, it, workers: int, lookahead: int):
    """Lazy ordered thread-pool map over a (possibly infinite) iterator:
    at most workers + lookahead tasks in flight, one submitted as each
    result is consumed; results in input order, a task's exception raised
    when its result is reached."""
    ex = ThreadPoolExecutor(max_workers=workers)
    pending: collections.deque = collections.deque()
    it = iter(it)

    def submit_next() -> bool:
        try:
            pending.append(ex.submit(fn, next(it)))
            return True
        except StopIteration:
            return False

    try:
        for _ in range(workers + lookahead):
            if not submit_next():
                break
        while pending:
            with profiling.span("loader_wait"):
                out = pending.popleft().result()
            submit_next()
            yield out
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


def eval_samples(dataset) -> Iterator[dict]:
    """Sequential full-size eval samples (batch-1 protocols)."""
    for i in range(len(dataset)):
        yield dataset[i]


def prefetch_iter(it: Iterator, depth: int = 2) -> Iterator:
    """Run `it` in a background thread, `depth` items ahead — overlaps host
    decode/resize with device compute. An exception in `it` is raised in
    the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    failure = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:   # handed to the consumer, re-raised there
            failure.append(e)
        finally:
            q.put(done)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        with profiling.span("wait"):
            item = q.get()
        if item is done:
            if failure:
                raise failure[0]
            return
        yield item
