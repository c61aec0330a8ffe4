"""Device operations a frame of the traced pass's last scan chunk (upload and `ScanStream.feed`), counted by the feed from the trace's start to the chunk's `scan` lap into `timings["#chunk_launches"]`."""


def read(ctx):
    n = ctx["timings"].get("#chunk_launches")
    if n is None or not ctx["traced_frames"]:
        return None
    return n / ctx["traced_frames"]
