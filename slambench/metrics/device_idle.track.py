"""The device's idle share of the traced live frames (%)."""

from slambench import readers


def read(ctx):
    return readers.device_idle(ctx)
