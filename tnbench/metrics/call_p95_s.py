"""The 95th percentile of the latency of every call in the window, from
its start to the end of its pull (host clock; numpy's linear
interpolation)."""

import numpy as np


def read(run):
    lat = [c.end - c.start for c in run.calls]
    if not lat:
        return None
    return float(np.percentile(lat, 95))
