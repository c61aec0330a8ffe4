"""Keyframe map building, milliseconds a frame: the stage clock's `map`."""

from slambench import readers


def read(ctx):
    return readers.stage_ms(ctx, "map")
