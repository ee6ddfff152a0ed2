"""Host milliseconds the codec takes to decode a streamed batch: the
program's `decode` spans (the reader's prefetch thread) over the traced
passes of `program_trace`, over their batches; the busy time beside
`decode_wait_ms_per_batch`'s wait."""

NAME, UNIT, BETTER, SOURCE = "decode_ms_per_batch.streamed", "ms", "lower", "program_span"
LAYER = "io/traj.py reader and io/native.py codec (host)"
MOVES = "streamed_frames_per_s"


def read(ctx):
    if ctx.traffic["entry"] != "streamed":
        return None
    from portbench import program_trace

    pt = program_trace.get(ctx)
    return None if pt is None else pt["decode_ms_per_batch"]
