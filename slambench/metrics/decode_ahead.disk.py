"""Share (%) of the frames that the Python loader's decode workers had
decoded before the scan asked for them, over the untraced passes: System's
stage clock's `#decode_ahead` count (`data/prefetch.py::PythonPrefetcher`'s
`ready`, added once a `System.run()`) over the frames. 100% means the scan
never waited on a frame's PNG decode; the first chunk's frames, asked for
as the workers start, read low. None where the program has no such count
(a `System` without decode-ahead, or the native loader)."""


def read(ctx):
    n = ctx["timings"].get("#decode_ahead")
    if n is None or not ctx["frames"]:
        return None
    return 100.0 * n / ctx["frames"]
