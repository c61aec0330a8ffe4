"""Process start to the window's start (s)."""


def read(ctx):
    return ctx["setup_s"]
