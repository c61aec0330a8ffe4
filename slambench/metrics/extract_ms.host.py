"""ORB of one frame at a time in a System pass of the host pipeline (the image's copy in, the pyramid and kernel K1 at B=1, the features' copies out to numpy), milliseconds a frame: System's stage clock's `extract` over the untraced passes."""

from slambench import readers


def read(ctx):
    return readers.stage_ms(ctx, "extract")
