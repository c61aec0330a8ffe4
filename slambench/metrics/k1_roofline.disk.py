"""Kernel K1's share of its H100 bound over the traced part of a System pass, whose only ORB is its last scan chunk (%)."""

from slambench import readers


def read(ctx):
    return readers.k1_roofline(ctx)
