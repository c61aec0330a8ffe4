"""Matching and estimation of consecutive pairs (PnP or essential RANSAC), milliseconds a frame: the stage clock's `pairs`."""

from slambench import readers


def read(ctx):
    return readers.stage_ms(ctx, "pairs")
