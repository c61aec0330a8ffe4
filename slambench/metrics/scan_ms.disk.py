"""The scan tracker over the decoded chunks (upload and `ScanStream.feed`: ORB, the per-frame step, keyframe events, local BA, the ring's harvest), milliseconds a frame: System's stage clock's `scan` over the untraced passes."""

from slambench import readers


def read(ctx):
    return readers.stage_ms(ctx, "scan")
