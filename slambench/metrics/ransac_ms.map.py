"""PnP and essential RANSAC outside Gauss-Newton (sampling, minimal solves, scoring, inlier masks) in every offline stage, milliseconds a frame on the host: the stage clock's `<stage>/ransac` spans."""

from slambench import spans


def read(ctx):
    return spans.span_ms(ctx, "ransac")
