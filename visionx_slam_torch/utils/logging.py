"""Logging setup (the reference's Logger component, core/common/logger.{h,cpp}:
glog to stderr at INFO, colorized). Python logging with a compact glog-like
format plus optional per-frame JSONL structured metrics (SURVEY.md §5.5)."""

from __future__ import annotations

import json
import logging
import sys
import time
from contextlib import contextmanager


def init_logger(name: str = "vxs", level: int = logging.INFO) -> logging.Logger:
    logging.basicConfig(
        level=level,
        format="%(levelname).1s%(asctime)s.%(msecs)03d %(name)s] %(message)s",
        datefmt="%m%d %H:%M:%S",
        stream=sys.stderr,
    )
    return logging.getLogger(name)


class JsonlWriter:
    """Structured per-frame metrics sink (replaces the glog LOG(INFO) lines
    scattered through tracking.cpp with one machine-readable record)."""

    def __init__(self, path: str):
        self._f = open(path, "w")

    def write(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")

    def close(self) -> None:
        self._f.close()


class StageTimer:
    """Accumulating per-stage wall timers (SURVEY.md §5.1: the reference has
    only a viewer FPS counter; we time every stage)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1),
            }
            for k in self.totals
        }
