"""Kernel K4's share (%) of its H100 bound over the traced part of a System pass (the last scan chunk's keyframe events): the profiler's `triangulate_kernel` time against `slambench/kernels.py`'s bytes and operations of a call over 1024 query features."""

from slambench import kernels


def read(ctx):
    return kernels.k4_roofline(ctx)
