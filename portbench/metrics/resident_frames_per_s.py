"""Frames per second of a resident window's passes: all frames of all
passes over the window's wall time (first pass start to last pass end)."""

NAME, UNIT, BETTER, SOURCE = "resident_frames_per_s", "frames/s", "higher", "host_clock"


def read(ctx):
    if ctx.traffic["entry"] != "resident" or not ctx.passes:
        return None
    return ctx.frames * len(ctx.passes) / ctx.window_s
