"""Local BA in the host Tracker (each `local_ba` call of a keyframe event, one launch of kernel K3 on the card, and the read of its cost), milliseconds a frame on the host: System's stage clock's `track/lba` spans over the untraced passes. None where the program has no such span."""


def read(ctx):
    t = ctx["timings"].get("track/lba")
    if t is None or not ctx["frames"]:
        return None
    return 1e3 * t / ctx["frames"]
