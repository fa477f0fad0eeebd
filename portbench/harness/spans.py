"""Spans from the benchmark's own wrappers around the program's calls.

`Spans.wrap(module, name, span)` replaces a module attribute (a function
the measured code calls through its module's globals) by a wrapper that
times each call on the host clock and, while the device trace runs, opens
a `record_function` range named "portbench.<span>", so that the trace can
give the device time launched under it. `restore()` puts every original
back. Durations are kept per span name; `mark()` starts a new window.
"""
from __future__ import annotations

import time
from collections import defaultdict


class Spans:
    def __init__(self):
        self.tracing = False
        self.durations: dict = defaultdict(list)
        self._saved: list = []

    def mark(self) -> None:
        self.durations = defaultdict(list)

    def total(self, name: str) -> float:
        return float(sum(self.durations.get(name, ())))

    def count(self, name: str) -> int:
        return len(self.durations.get(name, ()))

    def timed(self, span: str, fn, before=None, after=None):
        """fn wrapped in the span; before(args, kwargs) runs first and
        after(result, args, kwargs) last, both outside the timing."""
        from torch.autograd.profiler import record_function

        def wrapper(*args, **kwargs):
            if before is not None:
                before(args, kwargs)
            t0 = time.perf_counter()
            if self.tracing:
                with record_function("portbench." + span):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            self.durations[span].append(time.perf_counter() - t0)
            if after is not None:
                after(out, args, kwargs)
            return out

        return wrapper

    def wrap(self, module, name: str, span: str, before=None, after=None):
        original = getattr(module, name)
        self._saved.append((module, name, original))
        setattr(module, name, self.timed(span, original, before, after))
        return original

    def wrap_iter(self, module, name: str, span: str):
        """A function that returns an iterator: each next() on the result
        is timed as `span` (the consumer waiting for it)."""
        original = getattr(module, name)
        spans = self

        def wrapper(*args, **kwargs):
            it = iter(original(*args, **kwargs))
            step = spans.timed(span, lambda: next(it))
            while True:
                try:
                    item = step()
                except StopIteration:
                    return
                yield item

        self._saved.append((module, name, original))
        setattr(module, name, wrapper)

    def replace(self, module, name: str, make) -> None:
        """Put make(original) in the attribute's place until restore()."""
        original = getattr(module, name)
        self._saved.append((module, name, original))
        setattr(module, name, make(original))

    def restore(self) -> None:
        while self._saved:
            module, name, original = self._saved.pop()
            setattr(module, name, original)
