"""Seconds of `PipelineRunner.load_device` in set-up (the benchmark's span
around the call, ending in a synchronize)."""

NAME, UNIT, BETTER, SOURCE = "load_device_s", "s", "lower", "program_span"
LAYER = "models/pipeline.py PipelineRunner.load_device"
MOVES = "setup_s"


def read(ctx):
    return ctx.spans.seconds("load_device")
