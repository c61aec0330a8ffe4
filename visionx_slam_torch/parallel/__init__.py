"""Throughput mode over several devices (``parallel.batch``)."""
