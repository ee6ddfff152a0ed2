"""Host milliseconds of staging a streamed batch (pinned fill and H2D
issue): `FrameEngine.last_stage_seconds["stage"]` summed over the
window's passes, over the window's batches."""

NAME, UNIT, BETTER, SOURCE = "stage_ms_per_batch", "ms", "lower", "program_counter"
LAYER = "parallel/engine.py staging (pinned fill, H2D)"
MOVES = "streamed_frames_per_s"


def read(ctx):
    if not ctx.stage_batches or "stage" not in ctx.stage_totals:
        return None
    return ctx.stage_totals["stage"] / ctx.stage_batches * 1e3
