"""ORB (K1 + description) milliseconds a frame: the offline stage clock's `extract`."""

from slambench import readers


def read(ctx):
    return readers.stage_ms(ctx, "extract")
