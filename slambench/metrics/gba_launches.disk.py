"""Launches of one `pair_ba` solve over the union map: the CUDA runtime calls that enqueue device work (kernel launches, copies, fills) made by the host inside the traced pass's `gba/solve` span (the solve with its two reprojection errors and the reads of its results), counted by the feed into `timings["#gba_launches"]`."""


def read(ctx):
    return ctx["timings"].get("#gba_launches")
