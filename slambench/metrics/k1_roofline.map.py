"""Kernel K1's share of its H100 bound in the offline passes (%)."""

from slambench import readers


def read(ctx):
    return readers.k1_roofline(ctx)
