"""Device operations a frame in the traced offline pass."""

from slambench import readers


def read(ctx):
    return readers.launches_per_frame(ctx)
