"""Reading and decoding the TUM files (the scan thread's wait for a chunk's frames), milliseconds a frame: System's stage clock's `decode` over the untraced passes."""

from slambench import readers


def read(ctx):
    return readers.stage_ms(ctx, "decode")
