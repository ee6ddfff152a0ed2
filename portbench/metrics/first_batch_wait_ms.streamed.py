"""Host milliseconds from the start of a streamed pass to the end of its
first wait for the reader: the program's `pass` span to its first
`decode_wait` (opening the reader, the one-shot size check, the first
batch's decode), median over the traced passes of `program_trace`."""

NAME, UNIT, BETTER, SOURCE = "first_batch_wait_ms.streamed", "ms", "lower", "program_span"
LAYER = "io/traj.py reader and io/native.py codec (host)"
MOVES = "streamed_frames_per_s"


def read(ctx):
    if ctx.traffic["entry"] != "streamed":
        return None
    from portbench import program_trace

    pt = program_trace.get(ctx)
    return None if pt is None else pt["first_batch_wait_ms"]
