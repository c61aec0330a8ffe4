"""Pose-only Gauss-Newton in the scan of a System pass (to the end of each `_pose_gn_refine` call on kernel K2, from the previous span: the motion prior's set-up and its refines), milliseconds a frame on the host: System's stage clock's `scan/gn` spans over the untraced passes."""


def read(ctx):
    t = ctx["timings"].get("scan/gn")
    if t is None or not ctx["frames"]:
        return None
    return 1e3 * t / ctx["frames"]
