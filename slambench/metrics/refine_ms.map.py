"""Global bundle adjustment, milliseconds a frame: the stage clock's `refine`."""

from slambench import readers


def read(ctx):
    return readers.stage_ms(ctx, "refine")
