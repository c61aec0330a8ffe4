"""Reading and decoding the TUM files in a System pass of the host pipeline (the frame loop's wait for each frame's decoded files), milliseconds a frame: System's stage clock's `decode` over the untraced passes."""

from slambench import readers


def read(ctx):
    return readers.stage_ms(ctx, "decode")
