"""The batched re-track against the refined map, milliseconds a frame: the stage clock's `retrack`."""

from slambench import readers


def read(ctx):
    return readers.stage_ms(ctx, "retrack")
