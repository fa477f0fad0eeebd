"""Spans, counters and the trace exporter of the port (the counterpart of
excel_tpu/utils/profiling.py).

- `span(name, **attrs)`: a context manager around one layer's work. Off
  (the default) it costs one flag test and returns a shared no-op context:
  no profiler range, no clock read, nothing stored. On, it opens a
  `record_function` range named "excel.<name>" (with the attrs as a short
  "key=value" string, such as "batch=17 images=4") and keeps a record of
  the span: its name, its parent record (the span open on the same
  thread), the thread, and its start and end in `time.time_ns()`
  nanoseconds, the clock the profiler's Kineto events are stamped in, so
  that a record lines up with the device trace as it is. At most
  MAX_RECORDS records are kept; beyond that `dropped` counts the rest. The
  profiler records the ranges of the thread that started it; the spans of
  other threads (the eval sweeps' prefetch thread: `read`, `prep`) are in
  the records alone.
- `count(name, n=1)`: adds to a counter, only while on.
- `enable(flag)`, `enabled()`, `reset()`, `snapshot()`, `records()`: the
  state. `snapshot()` gives the counters and per span name its count,
  total and self seconds (self: the span's time less that of its child
  spans on its thread).
- `trace(logdir)`: a `torch.profiler` trace of the block (host ops and, on
  a CUDA device, the device's kernels) written to `<logdir>/trace.json`,
  loadable in chrome://tracing or Perfetto, with the spans on for the block
  and their snapshot in `<logdir>/spans.json`.

Spans and counters read host values only: none of them reads a device
tensor, waits for the device or launches a kernel.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch

MAX_RECORDS = 200_000

_on = False
_lock = threading.Lock()
_local = threading.local()
_records: list = []        # Record, or None while its span is open
_counters: dict = defaultdict(int)
_dropped = 0
_generation = 0            # reset() starts a new one


class Record(NamedTuple):
    name: str
    parent: int        # index of the enclosing record on the thread, or -1
    thread: int
    start_ns: int
    end_ns: int
    attrs: str


class _Off:
    """The shared context of a span while the spans are off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "range", "index", "generation", "start")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = " ".join(f"{k}={v}" for k, v in attrs.items())

    def __enter__(self):
        global _dropped
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        with _lock:
            self.generation = _generation
            if len(_records) < MAX_RECORDS:
                self.index = len(_records)
                _records.append(None)
            else:
                self.index = -1
                _dropped += 1
        stack.append(self)
        self.start = time.time_ns()
        self.range = torch.autograd.profiler.record_function(
            "excel." + self.name, self.attrs or None)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        end = time.time_ns()
        stack = _local.stack
        stack.pop()
        if self.index < 0:
            return False
        parent = -1
        if stack and stack[-1].generation == self.generation:
            parent = stack[-1].index
        with _lock:
            if self.generation == _generation:
                _records[self.index] = Record(
                    self.name, parent, threading.get_ident(), self.start,
                    end, self.attrs)
        return False


def span(name: str, **attrs):
    """The span `name` around a `with` block (module docstring)."""
    if not _on:
        return _OFF
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add `n` (a host number) to the counter `name` while the spans are
    on."""
    if not _on:
        return
    with _lock:
        _counters[name] += n


def enabled() -> bool:
    return _on


def enable(flag: bool = True) -> None:
    global _on
    _on = bool(flag)


def reset() -> None:
    """Forget every record and counter."""
    global _dropped, _generation
    with _lock:
        _records.clear()
        _counters.clear()
        _dropped = 0
        _generation += 1


def records() -> list:
    """Every kept span's Record in the order the spans opened (None for a
    span still open); a record's `parent` indexes this list."""
    with _lock:
        return list(_records)


def snapshot() -> dict:
    """{"counters": {name: n}, "spans": {name: {"count", "total_s",
    "self_s"}}, "dropped": spans not kept}, over the spans that have
    ended."""
    with _lock:
        recs = list(_records)
        counters = dict(_counters)
        dropped = _dropped
    child_ns = [0] * len(recs)
    for r in recs:
        if r is not None and r.parent >= 0:
            child_ns[r.parent] += r.end_ns - r.start_ns
    spans: dict = {}
    for r, kids in zip(recs, child_ns):
        if r is None:
            continue
        s = spans.setdefault(r.name, {"count": 0, "total_s": 0.0,
                                      "self_s": 0.0})
        dur = r.end_ns - r.start_ns
        s["count"] += 1
        s["total_s"] += dur / 1e9
        s["self_s"] += (dur - kids) / 1e9
    return {"counters": counters, "spans": spans, "dropped": dropped}


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with the spans on (their state reset first); on
    exit write `<logdir>/trace.json` and `<logdir>/spans.json`."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was_on = _on
    reset()
    enable(True)
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        enable(was_on)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(snapshot(), f, indent=1, sort_keys=True)
