"""Idle share of the device over the traced passes of a resident window
(the window's own passes, `traced_passes` of them): 1 - (union of the
device's kernel, copy and memset intervals) / (the traced window), from
the profiler's trace; a trace that lost records is never read."""

NAME, UNIT, BETTER, SOURCE = "device_idle_pct.resident", "%", "lower", "device_trace"
LAYER = "device"
MOVES = "resident_frames_per_s"


def read(ctx):
    if ctx.traffic["entry"] != "resident" or not ctx.trace_info:
        return None
    info = ctx.trace_info
    return 100.0 * (1.0 - info["busy_s"] / info["window_s"])
