"""A keyframe event of the host Tracker up to local BA (the keyframe's insert, its depth landmarks, two-view triangulation on kernel K4), milliseconds a frame on the host: System's stage clock's `track/kf` spans over the untraced passes. None where the program has no such span."""


def read(ctx):
    t = ctx["timings"].get("track/kf")
    if t is None or not ctx["frames"]:
        return None
    return 1e3 * t / ctx["frames"]
