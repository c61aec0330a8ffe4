"""Descriptor matching in the scan of a System pass (each frame against its keyframe, from the end of the previous span: the chunk's `scan/orb`, the previous frame's `scan/step`), milliseconds a frame on the host: System's stage clock's `scan/match` spans over the untraced passes."""


def read(ctx):
    t = ctx["timings"].get("scan/match")
    if t is None or not ctx["frames"]:
        return None
    return 1e3 * t / ctx["frames"]
