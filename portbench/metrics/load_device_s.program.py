"""Seconds of `PipelineRunner.load_device` by the program's own
`load_device` span: one more load of the cell's trajectory after the
window (`program_trace`; the file read warm), its window dropped."""

NAME, UNIT, BETTER, SOURCE = "load_device_s.program", "s", "lower", "program_span"
LAYER = "models/pipeline.py PipelineRunner.load_device"
MOVES = "setup_s"


def read(ctx):
    if ctx.traffic["entry"] != "resident":
        return None
    from portbench import program_trace

    pt = program_trace.get(ctx)
    return None if pt is None else pt["load_device_s"]
