"""Local BA in the scan of a System pass over depth files with holes (each `local_ba` call of a keyframe event, one launch of kernel K3 on the card), milliseconds a frame on the host: System's stage clock's `scan/lba` spans over the untraced passes."""


def read(ctx):
    t = ctx["timings"].get("scan/lba")
    if t is None or not ctx["frames"]:
        return None
    return 1e3 * t / ctx["frames"]
