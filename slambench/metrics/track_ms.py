"""The live window's time over the frames tracked in it (ms)."""


def read(ctx):
    return 1e3 * ctx["wall_s"] / ctx["frames"]
