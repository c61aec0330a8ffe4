"""Places a System pass of the host pipeline made the host wait for the device (ORB's copies in and out, the features' copies in, the host Tracker's reads, the harvests' copies, the global BA's reads, the outputs' reads), a frame: System's stage clock's `#host_syncs` over the untraced passes; the clock's own synchronizes are not counted."""

from slambench import spans


def read(ctx):
    return spans.syncs_per_frame(ctx)
