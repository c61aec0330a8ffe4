"""The device's idle share of the traced part of a System pass of the host pipeline, its last frames to its end (%)."""

from slambench import readers


def read(ctx):
    return readers.device_idle(ctx)
