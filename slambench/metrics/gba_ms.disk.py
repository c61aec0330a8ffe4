"""The global BA after the sequence (the last harvest, the union map of every archived keyframe, the `pair_ba` solve, the refined keyframe trajectory), milliseconds a frame of the pass: System's stage clock's `gba` over the untraced passes."""

from slambench import readers


def read(ctx):
    return readers.stage_ms(ctx, "gba")
