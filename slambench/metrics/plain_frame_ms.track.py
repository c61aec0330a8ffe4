"""Mean latency (ms) of live frames without a keyframe event."""

from slambench import readers


def read(ctx):
    return readers.frame_ms(ctx, False)
