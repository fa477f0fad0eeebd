"""Arithmetic shared by the per-layer metrics' readers (metrics/*.py).
Each returns None where the run has nothing to read, never 0 for a
share of a peak or a roofline."""
from __future__ import annotations

from . import peaks


def host_ms(reading, spans) -> float | None:
    """Mean host milliseconds a prepared batch of the named spans (the
    first names the batch: its count is the divisor)."""
    n = reading.spans.count(spans[0])
    if n == 0:
        return None
    return 1e3 * sum(reading.spans.total(s) for s in spans) / n


def wall_rate(reading) -> float | None:
    """Images of the window's work over its wall (host clock)."""
    images = reading.work.get("images", 0)
    if images <= 0 or reading.outcome.window_s <= 0:
        return None
    return images / reading.outcome.window_s


def _on_card(reading) -> bool:
    return reading.ctx.device.type == "cuda"


def device_idle(reading) -> float | None:
    tr = reading.trace
    if not _on_card(reading) or not tr or tr["window_s"] <= 0 or tr["kernels"] == 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu(reading) -> float | None:
    """Matrix-product FLOPs counted from shapes over the traced window,
    against the peak of the configuration's compute type."""
    tr = reading.trace
    flops = reading.work.get("flops", 0.0)
    if not _on_card(reading) or not tr or tr["window_s"] <= 0 or flops <= 0:
        return None
    dtype = str(reading.ctx.cfg.clip.compute_dtype).split(".")[-1]
    return 100.0 * flops / (tr["window_s"] * peaks.matmul_peak(dtype))


def roofline(reading, span: str, bound_key: str) -> float | None:
    """The layer's least time from its shapes over the device time launched
    under its span, within the traced window."""
    tr = reading.trace
    if not _on_card(reading) or not tr:
        return None
    t = tr["span_device_s"].get(span, 0.0)
    bound = reading.work.get(bound_key, 0.0)
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
