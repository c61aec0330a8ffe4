"""The host Tracker in a System pass of the host pipeline (the features' copies in, then `Tracker.process`: the PnP against the keyframe, the local map, keyframe events with triangulation and local BA, and its reads), milliseconds a frame: System's stage clock's `track` over the untraced passes."""

from slambench import readers


def read(ctx):
    return readers.stage_ms(ctx, "track")
