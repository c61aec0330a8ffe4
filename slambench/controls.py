"""The control and the faults that the limits in ``limits/`` are held
against. None of them runs in a benchmark run: the tests in this folder and
the readings recorded in PERF.md drive them.

The control (the configuration states no arithmetic precision, so it
breaks a guarantee the configuration does state, at bfloat16, the nearest
precision below the float32 the quantity is held in):

- ``depth_bf16``: the depth images rounded to bfloat16 before the program
  sees them (the map keeps each feature's depth at 1/5000 m).

Faults of the timed path, each planted under a feed's entry point
(``fault``):

- ``unchanged``: every frame returns the first frame's pose (a step that
  returns its state unchanged);
- ``half``: the second half of the frames (of the lanes, in a folded run)
  left out, returned at the identity;
- ``altered``: one frame's position moved by 1 m where it is produced (a
  pose that belongs to no frame of the pass).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def depth_bf16(feed):
    d = feed.d
    if isinstance(d, torch.Tensor):
        feed.d = d.to(torch.bfloat16).float()
    else:
        feed.d = torch.from_numpy(d).to(torch.bfloat16).float().numpy()
    try:
        yield
    finally:
        feed.d = d


def _broken_poses(kind: str, pose: torch.Tensor) -> torch.Tensor:
    """[T,4,4] (or folded [B,T,4,4]) poses broken by ``kind``: ``half``
    leaves out the second half of the frames (of the lanes when folded)."""
    pose = pose.clone()
    if kind == "unchanged":
        pose[...] = pose[..., :1, :, :]
    elif kind == "half":
        pose[pose.shape[0] // 2:] = torch.eye(4, dtype=pose.dtype,
                                              device=pose.device)
    elif kind == "altered":
        pose[..., pose.shape[-3] // 2, 0, 3] += 1.0
    return pose


@contextlib.contextmanager
def fault(feed, kind: str):
    """Plant fault ``kind`` under the feed's entry point."""
    if hasattr(feed, "one_pass"):
        orig = feed.one_pass

        def one_pass(timings=None):
            ms, out = orig(timings)
            return ms, out._replace(pose=_broken_poses(kind, out.pose))

        feed.one_pass = one_pass
        try:
            yield
        finally:
            del feed.one_pass
        return
    orig = feed._frame
    state = {"first": None}

    def frame(stream, i):
        p = orig(stream, i)
        if state["first"] is None:
            state["first"] = p
        if kind == "unchanged":
            p = state["first"]
        elif kind == "half" and i % 2:
            p = torch.eye(4, dtype=p.dtype)[None]
        elif kind == "altered" and i == 2:
            p = p.clone()
            p[0, 0, 3] += 1.0
        return p

    feed._frame = frame
    try:
        yield
    finally:
        del feed._frame


FAULTS = ("unchanged", "half", "altered")

