"""Share (%) of the untraced passes' frames whose steady tracked step ran
as one replay of the scan's CUDA graph (`tracking/scan_pipeline.py::
TrackGraph`: the keyframe match, `pnp_prior` and the consensus flags):
System's `#track_graph` count (the scan's `ScanCounters.track_graph`, added
once a `System.run()`) over the frames. The initialization's frames and any
frame after a tracking failure take other branches, so a pass that tracks
every frame reads just under 100%. None where the program has no such
count (a scan without the graph)."""


def read(ctx):
    n = ctx["timings"].get("#track_graph")
    if n is None or not ctx["frames"]:
        return None
    return 100.0 * n / ctx["frames"]
