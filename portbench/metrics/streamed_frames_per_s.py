"""Frames per second of passes from a trajectory file: all frames of all
passes over the window's wall time (first pass start to last pass end)."""

NAME, UNIT, BETTER, SOURCE = "streamed_frames_per_s", "frames/s", "higher", "host_clock"


def read(ctx):
    if ctx.traffic["entry"] != "streamed" or not ctx.passes:
        return None
    return ctx.frames * len(ctx.passes) / ctx.window_s
