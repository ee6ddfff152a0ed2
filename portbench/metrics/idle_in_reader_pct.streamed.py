"""Share of the traced window the device sits idle while a streamed pass
opens its reader or waits for a decoded batch: idle gaps of the device
trace named by the program's `open` or `decode_wait` spans
(`program_trace`), as a % of the traced window."""

NAME, UNIT, BETTER, SOURCE = "idle_in_reader_pct.streamed", "%", "lower", "device_trace"
LAYER = "io/traj.py reader and io/native.py codec (host)"
MOVES = "streamed_frames_per_s"


def read(ctx):
    if ctx.traffic["entry"] != "streamed":
        return None
    from portbench import program_trace

    pt = program_trace.get(ctx)
    return None if pt is None else pt["idle_in_reader_pct"]
