"""Host milliseconds a frame of the hydrogen-bond cell path spends in the
candidate walk and its packing: the program's `hbond/walk` spans
(`system/hbonds.py`, the C++ cell walk and the rank tables) over the
traced passes of `program_trace`, a pass's total over its frames."""

NAME, UNIT, BETTER, SOURCE = "hbond_walk_ms_per_frame", "ms", "lower", "program_span"
LAYER = "system/hbonds.py hydrogen-bond cell path (host walk, rank wire, device scorer)"
MOVES = "streamed_frames_per_s"
SPAN = "hbond/walk"


def read(ctx):
    if ctx.traffic["entry"] != "streamed":
        return None
    from portbench import program_trace

    pt = program_trace.get(ctx)
    if pt is None or SPAN not in pt["host_ms_per_pass"]:
        return None
    return pt["host_ms_per_pass"][SPAN] / ctx.frames
