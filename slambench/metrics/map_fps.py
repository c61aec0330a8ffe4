"""Frames of all mapping passes of the window over the window's time, from
its start to the end of its last pass (frames/s)."""


def read(ctx):
    return ctx["frames"] / ctx["wall_s"]
