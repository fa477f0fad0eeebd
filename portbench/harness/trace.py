"""The device trace of a traced window and its reduction.

The profiler (torch.profiler's Kineto backend, CPU and CUDA activities, or
CUDA alone where only the device's busy time is read) is started and stopped through its low-level entry points, so that the raw
events are read without building torch's per-op summary. The reduction
gives the device's busy seconds (the union of every kernel, copy and set on
the device) within the traced window, the device time launched under each
"portbench.<span>" range (a kernel belongs to the range that was open on
the thread that launched it), device time by kernel name, and the idle
gaps by what the launching thread was doing (its innermost "portbench."
range, else "host").
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict


class Tracer:
    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.active = False
        self.started = False
        self.events = None
        self.result: dict | None = None

    def start(self, device_only: bool = False) -> None:
        from torch._C._profiler import (ProfilerActivity, ProfilerConfig,
                                        ProfilerState, _ExperimentalConfig)
        from torch.autograd import profiler as P

        self._acts = set() if device_only else {ProfilerActivity.CPU}
        if self.cuda:
            self._acts.add(ProfilerActivity.CUDA)
        self._cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                                   False, False, _ExperimentalConfig())
        P._prepare_profiler(self._cfg, self._acts)
        self.t0_ns = time.time_ns()
        P._enable_profiler(self._cfg, self._acts)
        self.active = self.started = True

    def stop(self) -> None:
        from torch.autograd import profiler as P

        self.t1_ns = time.time_ns()
        self.events = P._disable_profiler()
        self.active = False

    def reduce(self) -> dict | None:
        """The reduction of the traced window (after the window closed)."""
        if self.events is not None and self.result is None:
            self.result = reduce(self.events.events(), self.t0_ns,
                                 self.t1_ns)
            self.events = None
        return self.result


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _counts(ranges) -> dict:
    out = defaultdict(int)
    for (_, name), lst in ranges.items():
        out[name] += len(lst)
    return dict(out)


def reduce(events, t0: int, t1: int) -> dict:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kernels, launches = [], {}
    ranges = defaultdict(list)          # (thread, name) -> [(start, end)]
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if e.is_user_annotation() or e.duration_ns() <= 0:
                continue
            kernels.append((e.start_ns(), e.end_ns(), name,
                            e.correlation_id()))
        elif e.is_user_annotation():
            if name.startswith("portbench."):
                ranges[e.start_thread_id(), name[10:]].append(
                    (e.start_ns(), e.end_ns()))
        elif name.startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
    starts = {}
    for key, lst in ranges.items():
        lst.sort()
        starts[key] = [s for s, _ in lst]
    names_by_thread = defaultdict(list)
    for thread, name in ranges:
        names_by_thread[thread].append(name)

    def spans_at(thread, ts):
        found = []
        for name in names_by_thread.get(thread, ()):
            lst = ranges[thread, name]
            i = bisect.bisect_right(starts[thread, name], ts) - 1
            if i >= 0 and lst[i][1] >= ts:
                found.append((lst[i][1] - lst[i][0], name))
        return [n for _, n in sorted(found)]

    span_ns = defaultdict(int)
    by_name = defaultdict(int)
    clipped = []
    for s, e, name, corr in kernels:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        clipped.append((s, e))
        by_name[name] += e - s
        launch = launches.get(corr)
        if launch is not None:
            for span in set(spans_at(launch[1], launch[0])):
                span_ns[span] += e - s
    busy = _merge(clipped)
    busy_ns = sum(e - s for s, e in busy)
    # idle gaps, labelled by the innermost span open on the threads that
    # launch work (those that own "step" ranges, else any)
    launch_threads = {t for (t, n) in ranges if n == "step"} or \
        {t for (t, _) in ranges}
    gaps = defaultdict(int)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        label = "host"
        for t in launch_threads:
            inner = spans_at(t, mid)
            if inner:
                label = "host:" + inner[0]
                break
        gaps[label] += b - a
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "span_device_s": {k: v / 1e9 for k, v in span_ns.items()},
        "span_count": _counts(ranges),
        "device_ops": [[n[:160], v / 1e9] for n, v in top_ops],
        "idle_gaps": [[n, v / 1e9] for n, v in top_gaps],
        "kernels": len(clipped),
    }
