"""Logging setup (the reference's Logger component, core/common/logger.{h,cpp}:
glog to stderr at INFO, colorized). Python logging with a compact glog-like
format plus optional per-frame JSONL structured metrics (SURVEY.md §5.5),
and the stage clock that times ``System``'s stages and the offline
pipeline's, with its sub-spans and host-sync counter."""

from __future__ import annotations

import json
import logging
import sys
import time
from contextlib import contextmanager

import torch


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


HOST_SYNCS = "#host_syncs"

# the clock of the offline pass running with a ``timings`` dict, if any:
# what ``span`` and ``count_sync`` reach from the shared functions
_active: StageClock | None = None


class StageClock:
    """The offline pipeline's stage clock. With ``timings`` None it records
    nothing. Otherwise:

    - ``lap(stage)`` synchronizes the device and adds the seconds since the
      previous lap to ``timings[stage]``, counting the clock's laps of each
      stage in ``laps``;
    - ``span(name)`` adds the host seconds since the previous lap or span to
      ``timings["<stage>/<name>"]``, ``stage`` being the one ``begin``
      opened, without a synchronize: a stage's spans tile it from its
      start, and whatever follows its last span (the synchronize included)
      has no key but the stage's own, which keeps the stage's whole time;
    - the module's ``count_sync(n)`` counts places where the host waits for
      the device (device-to-host reads, blocking host-to-device copies,
      status checks), not the clock's own synchronizes; ``active()`` adds
      the count to ``timings["#host_syncs"]`` at its end.

    Every key is written when its interval ends, so a ``timings`` dict that
    marks its writes on a profiler's clock names every stretch of a trace.
    Values accumulate over passes."""

    def __init__(self, timings: dict | None, device: torch.device):
        self.timings = timings
        self.device = device
        self.stage = None
        self.syncs = 0
        self.laps: dict[str, int] = {}
        self.t0 = self.t_span = self._now() if timings is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _add(self, key: str, seconds: float) -> None:
        self.timings[key] = self.timings.get(key, 0.0) + seconds

    def begin(self, stage: str) -> None:
        self.stage = stage

    def lap(self, stage: str) -> None:
        if self.timings is None:
            return
        t = self._now()
        self._add(stage, t - self.t0)
        self.laps[stage] = self.laps.get(stage, 0) + 1
        self.t0 = self.t_span = t

    def span(self, name: str) -> None:
        t = time.perf_counter()
        self._add(f"{self.stage}/{name}", t - self.t_span)
        self.t_span = t

    @contextmanager
    def active(self):
        """Make this clock the one ``span`` and ``count_sync`` reach while
        the block runs, and write its sync count when the block ends; a
        clock without ``timings`` is never made active."""
        global _active
        if self.timings is None:
            yield
            return
        outer, _active = _active, self
        try:
            yield
        finally:
            _active = outer
        self.timings[HOST_SYNCS] = self.timings.get(HOST_SYNCS, 0) + self.syncs


def span(name: str) -> None:
    """End the sub-span ``name`` of the active clock's stage (nothing
    without an active clock)."""
    if _active is not None:
        _active.span(name)


def count_sync(n: int = 1) -> None:
    """Count ``n`` waits of the host for the device on the active clock
    (nothing without one)."""
    if _active is not None:
        _active.syncs += n
