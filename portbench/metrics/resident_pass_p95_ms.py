"""95th percentile of the resident passes' times, call to numpy results,
over every pass of the window (numpy's linear interpolation)."""

import numpy as np

NAME, UNIT, BETTER, SOURCE = "resident_pass_p95_ms", "ms", "lower", "host_clock"


def read(ctx):
    if ctx.traffic["entry"] != "resident" or not ctx.passes:
        return None
    return float(np.percentile([t1 - t0 for t0, t1 in ctx.passes], 95)) * 1e3
