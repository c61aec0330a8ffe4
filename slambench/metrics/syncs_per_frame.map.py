"""Places an offline pass made the host wait for the device (device-to-host reads, blocking copies in, status checks), a frame: the stage clock's `#host_syncs` over the untraced passes; its own synchronizes are not counted."""

from slambench import spans


def read(ctx):
    return spans.syncs_per_frame(ctx)
