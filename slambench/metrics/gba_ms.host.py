"""The global BA after the host pipeline's pass (the last harvest of the Tracker's ring, the union map of every archived keyframe with its two-view landmarks, the `pair_ba` solve with the disparity row, the refined keyframe trajectory), milliseconds a frame of the pass: System's stage clock's `gba` over the untraced passes."""

from slambench import readers


def read(ctx):
    return readers.stage_ms(ctx, "gba")
