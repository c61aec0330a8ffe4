"""Places a System pass made the host wait for the device (the scan's reads that `ScanCounters.host_syncs` counts, the copies in and out, the global BA's reads), a frame: System's stage clock's `#host_syncs` over the untraced passes; the clock's own synchronizes are not counted."""

from slambench import spans


def read(ctx):
    return spans.syncs_per_frame(ctx)
