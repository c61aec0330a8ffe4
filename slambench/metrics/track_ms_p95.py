"""The 95th percentile of every live frame's latency in the window, from
its hand-over to its pose on the host (ms)."""

import numpy as np


def read(ctx):
    return 1e3 * float(np.percentile(np.asarray(ctx["latency_s"]), 95))
