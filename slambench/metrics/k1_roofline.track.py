"""Kernel K1's share of its H100 bound at B=1 in the live tracker (%)."""

from slambench import readers


def read(ctx):
    return readers.k1_roofline(ctx)
