"""Cells cut to a size the CPU tests can hold: the same configuration,
feeds, reference and limits, over a few frames. The offline frames are taken
16 apart, so that a pass spans the loop and a wrong pose shows as it would
over a whole pass."""

from __future__ import annotations

from . import run as harness

SMALL = {"offline": dict(frames=16, frame_stride=16),
         "lanes": dict(lanes=2, frames=12, frame_stride=16),
         "live": dict(frames=16, warm_frames=3, trace_from=2, trace_frames=3)}


def spec(cell: str) -> dict:
    s = harness.load_cell(cell)
    t = dict(s["traffic"])
    t.update(SMALL[t["feed"]])
    s["traffic"] = t
    return s


def run(spec_: dict, seed: int, seconds: float, device="cpu", plant=None,
        trace: bool = False) -> dict:
    """One run of a cell's ``spec_`` on ``device`` without the harness's
    look for a chip; ``plant(feed)``, a context manager from
    ``controls``, is held around the warm-up and the window."""
    import contextlib
    import time

    from . import feeds

    orig = feeds.load(spec_["traffic"]["feed"])
    ctx = plant or (lambda d: contextlib.nullcontext())

    class Planted(orig):
        def warm(self):
            with ctx(self):
                return orig.warm(self)

        def window(self, s):
            with ctx(self):
                return orig.window(self, s)

    load = feeds.load
    feeds.load = lambda kind: Planted
    try:
        return harness.run_cell(spec_, seed, seconds, trace, device,
                                time.time())[0]
    finally:
        feeds.load = load
