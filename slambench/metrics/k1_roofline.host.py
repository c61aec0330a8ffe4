"""Kernel K1's share of its H100 bound over the traced part of a System pass of the host pipeline, whose ORB runs one frame a launch (B=1) over its last frames (%)."""

from slambench import readers


def read(ctx):
    return readers.k1_roofline(ctx)
