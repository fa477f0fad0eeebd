"""Counting the port's kernel calls in tests: the profiling counters
`launch.<C entry point>` that `build.launch` adds to, and a spy on a module
attribute for the calls of a wrapper on the CPU, where nothing launches.
Imports no JAX (the card's tests use it)."""
from __future__ import annotations

import contextlib

from excel_tpu_torch.utils import profiling


@contextlib.contextmanager
def launches():
    """Yields a dict that holds, once the block has ended, {C entry point:
    launches} of the block (profiling on for the block only, its state
    reset before and after)."""
    profiling.reset()
    profiling.enable(True)
    counts: dict = {}
    try:
        yield counts
    finally:
        counters = profiling.snapshot()["counters"]
        profiling.enable(False)
        profiling.reset()
        counts.update({k[len("launch."):]: v for k, v in counters.items()
                       if k.startswith("launch.")})


def launch_counters() -> dict:
    """The `launch.*` counters of the profiling state as it stands."""
    return {k: v for k, v in profiling.snapshot()["counters"].items()
            if k.startswith("launch.")}


def spy(monkeypatch, module, name: str) -> list:
    """module.<name> replaced (for the test) by a wrapper that calls it;
    returns the list the wrapper appends each call's arguments to."""
    real = getattr(module, name)
    calls: list = []

    def wrapper(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
    return calls
