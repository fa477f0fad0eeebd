"""Eval samples and background prefetch for the eval sweeps (the port's
copies of excel_tpu/data/loader.eval_samples and prefetch_iter)."""
from __future__ import annotations

import queue
import threading
from typing import Iterator


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
        item = q.get()
        if item is done:
            if failure:
                raise failure[0]
            return
        yield item
