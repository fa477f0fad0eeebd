"""Logging, meters, ETA (the port's copy of excel_tpu/utils/logutils.py)."""
from __future__ import annotations

import datetime
import logging
import sys
import time


def setup_logger(filename: str | None = None,
                 level=logging.INFO) -> logging.Logger:
    """A logger writing to stdout and, given a filename, to that file."""
    logger = logging.getLogger("excel_tpu_torch")
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s",
                            datefmt="%Y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if filename:
        fh = logging.FileHandler(filename)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class AverageMeter:
    """Windowed running means keyed by name."""

    def __init__(self):
        self._sums: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    def add(self, values: dict[str, float]) -> None:
        for k, v in values.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v)
            self._counts[k] = self._counts.get(k, 0) + 1

    def pop(self, key: str) -> float:
        v = self._sums.get(key, 0.0) / max(self._counts.get(key, 0), 1)
        self._sums.pop(key, None)
        self._counts.pop(key, None)
        return v


class Eta:
    """Wall-clock elapsed time and ETA of an iteration count."""

    def __init__(self, total_iters: int):
        self.start = time.time()
        self.total = total_iters

    def __call__(self, cur_iter: int) -> tuple[str, str]:
        elapsed = time.time() - self.start
        rate = elapsed / max(cur_iter, 1)
        eta = rate * (self.total - cur_iter)

        def fmt(s):
            return str(datetime.timedelta(seconds=int(s)))
        return fmt(elapsed), fmt(eta)


def log_sweep_rate(logger, n_images: int, t0: float) -> None:
    """Log a sweep's wall throughput from a perf_counter() start stamp."""
    dt = time.perf_counter() - t0
    logger.info("sweep: %d images in %.1fs (%.1f img/s, incl. start-up)",
                n_images, dt, n_images / max(dt, 1e-9))
