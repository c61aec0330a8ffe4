"""A scan keyframe event up to local BA (the keyframe's insert, its depth landmarks, two-view triangulation on kernel K4, culling), milliseconds a frame on the host: System's stage clock's `scan/kf` spans over the untraced passes."""


def read(ctx):
    t = ctx["timings"].get("scan/kf")
    if t is None or not ctx["frames"]:
        return None
    return 1e3 * t / ctx["frames"]
