"""The result line: metrics by name with their units, the device, the
trace's breakdown, and the numbers compared beside their limits (last)."""
from __future__ import annotations

import math
import sys

import torch

from . import cell


def device_info(ctx, outcome) -> dict:
    dev = ctx.device
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": ctx.workload["chips"]}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = int(outcome.memory_peak_bytes)
    return info


class Reading:
    """What a per-layer metric's reader sees: the run's context, its
    outcome (window, work counts, spans) and the trace's reduction."""

    def __init__(self, ctx, outcome, trace):
        self.ctx, self.outcome, self.trace = ctx, outcome, trace
        self.spans = ctx.spans
        self.work = outcome.work


def result_line(bench: dict, ctx, outcome) -> dict:
    metrics = {}
    device = device_info(ctx, outcome)
    breakdown = None
    for m in cell.cell_metrics(bench, ctx.workload["name"], ctx.trace):
        if ctx.trace:
            value = cell.load_module("metrics", m["name"]).read(
                Reading(ctx, outcome, ctx.tracer.reduce()))
            if value is None or not math.isfinite(value):
                continue
        else:
            value = outcome.e2e.get(m["name"])
            if value is None:       # a device metric of a run on the CPU
                continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if ctx.trace:
        tr = ctx.tracer.reduce()
        if tr is not None:
            device["busy_s"] = tr["busy_s"]
            device["window_s"] = tr["window_s"]
            breakdown = {"device_ops": tr["device_ops"],
                         "idle_gaps": tr["idle_gaps"]}
    correct = all(v <= lim for _, v, lim in outcome.checks)
    line = {"correct": bool(correct), "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics,
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["info"] = outcome.info
    line["checks"] = {n: {"value": float(v), "limit": float(lim)}
                      for n, v, lim in outcome.checks}
    return line


def print_checks(checks) -> None:
    for name, value, limit in checks:
        verdict = "ok" if value <= limit else "FAILED"
        print(f"check {name} {value!r} limit {limit!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
