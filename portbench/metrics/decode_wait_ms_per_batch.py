"""Host milliseconds a streamed batch waited for the reader and codec:
`FrameEngine.last_stage_seconds["decode_wait"]` summed over the window's
passes, over the window's batches."""

NAME, UNIT, BETTER, SOURCE = "decode_wait_ms_per_batch", "ms", "lower", "program_counter"
LAYER = "io/traj.py reader and io/native.py codec (host)"
MOVES = "streamed_frames_per_s"


def read(ctx):
    if not ctx.stage_batches or "decode_wait" not in ctx.stage_totals:
        return None
    return ctx.stage_totals["decode_wait"] / ctx.stage_batches * 1e3
