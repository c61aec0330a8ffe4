"""PnP RANSAC outside its Gauss-Newton calls in the scan of a System pass, milliseconds a frame on the host: System's stage clock's `scan/ransac` spans over the untraced passes."""


def read(ctx):
    t = ctx["timings"].get("scan/ransac")
    if t is None or not ctx["frames"]:
        return None
    return 1e3 * t / ctx["frames"]
