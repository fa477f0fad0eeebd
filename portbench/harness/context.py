"""What a driver is handed (`Context`) and what it hands back
(`Outcome`)."""
from __future__ import annotations

import dataclasses
import os
import time

import torch

from .spans import Spans
from .trace import Tracer


@dataclasses.dataclass
class Context:
    workload: dict           # the cell's entry in BENCHMARK.json
    cfg: object              # the program's ExcelConfig of the cell
    spec: dict               # the configuration file
    traffic: dict            # the traffic file
    limits: dict             # {check name: {"limit": ...}}
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    workdir: str             # scratch for the dataset tree (under TMPDIR)
    t_process: float         # perf_counter at the process's start
    control: str | None = None   # compare the reference at this precision
    fault: str | None = None     # a fault planted in that stand-in
    device_e2e: bool = False     # an end-to-end metric of the cell is read
                                 # from the device trace of the whole window
    spans: Spans = dataclasses.field(default_factory=Spans)
    tracer: Tracer = dataclasses.field(default_factory=Tracer)

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def trace_bounds(self) -> tuple[float, float]:
        """(start, end) of the traced part of the window, in seconds into
        it: the traffic's trace_seconds, centred, or the whole window."""
        span = min(self.seconds, float(self.traffic.get("trace_seconds",
                                                        self.seconds)))
        start = (self.seconds - span) / 2.0
        return start, start + span


@dataclasses.dataclass
class Outcome:
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    e2e: dict                # {end-to-end metric name: value}
    checks: list             # [(name, value, limit)]
    memory_peak_bytes: int
    work: dict = dataclasses.field(default_factory=dict)
    info: dict = dataclasses.field(default_factory=dict)


def compared(numbers: dict, limits: dict) -> list:
    """[(name, value, limit)] of the numbers that the cell's limits file
    names, in the driver's order; a number it does not name is reported
    only (PERF.md says why, with its readings)."""
    return [(k, v, limits[k]["limit"]) for k, v in numbers.items()
            if k in limits]


def _cpu_s() -> float:
    t = os.times()
    return t.user + t.system


class Window:
    """The measured window's clock, and the device trace toggled inside it
    at the traffic's bounds (--trace 1), or, in an untraced run of a cell
    whose end-to-end metric is the device's time, a trace of the device's
    activity alone over the whole window. `tick()` is called between units
    of work on the main thread and says whether the window is over. `host`
    gives, after the window, this process's CPU seconds over the window's:
    the same work at a lower rate and the same CPU use means slower
    cores."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.t0 = None
        self.t1 = None
        self.ticks: list = []
        self.tr0, self.tr1 = ctx.trace_bounds()
        self.host: dict = {}
        self.whole = False
        self._cpu0 = 0.0

    def open(self) -> None:
        self.ctx.synchronize()
        self.ctx.spans.mark()
        self.whole = (not self.ctx.trace and self.ctx.device_e2e
                      and self.ctx.device.type == "cuda")
        if self.whole:
            self.ctx.tracer.start(device_only=True)
        self._cpu0 = _cpu_s()
        self.t0 = time.perf_counter()
        if self.ctx.trace and self.tr0 <= 0:
            self._trace_on()

    def _trace_on(self):
        self.ctx.spans.tracing = True
        self.ctx.tracer.start()

    def _trace_off(self):
        self.ctx.tracer.stop()
        self.ctx.spans.tracing = False

    def tick(self) -> bool:
        el = time.perf_counter() - self.t0
        self.ticks.append(el)
        tr = self.ctx.tracer
        if self.ctx.trace:
            if not tr.started and el >= self.tr0:
                self._trace_on()
            elif tr.active and el >= self.tr1:
                self._trace_off()
        return el >= self.ctx.seconds

    def per_second(self) -> list:
        """Units of work ended in each whole second of the window."""
        out = [0] * (int(self.ctx.seconds) + 1)
        for t in self.ticks:
            out[min(int(t), len(out) - 1)] += 1
        return out

    def close(self) -> float:
        self.ctx.synchronize()
        self.t1 = time.perf_counter()
        cpu = _cpu_s() - self._cpu0
        if self.ctx.tracer.active:
            self._trace_off()
        wall = self.t1 - self.t0
        self.host = {"process_cpu_per_s": cpu / wall}
        return wall

    def device_ms_per(self, units: int) -> float | None:
        """Device-busy milliseconds (the union of every kernel, copy and
        set) over the whole window, per unit of the window's work; None
        unless the whole window's device activity was traced."""
        tr = self.ctx.tracer.reduce() if self.whole else None
        if tr is None or units <= 0 or tr["kernels"] == 0:
            return None
        return 1e3 * tr["busy_s"] / units
