"""Hamming matching (`match_frames`) in every offline stage, milliseconds a frame on the host: the stage clock's `<stage>/match` spans."""

from slambench import spans


def read(ctx):
    return spans.span_ms(ctx, "match")
