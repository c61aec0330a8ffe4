"""Device-to-host reads the live tracker's decisions made a frame
(``ScanCounters.host_syncs`` through ``ScanStream.stats()``), over the
window's frames; the benchmark's own read of each pose is not counted."""


def read(ctx):
    c = ctx.get("counters")
    if not c or not ctx["window_frames"]:
        return None
    return c["host_syncs"] / ctx["window_frames"]
