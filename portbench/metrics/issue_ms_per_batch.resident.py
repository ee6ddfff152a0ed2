"""Host milliseconds the resident loop takes to issue a batch: the
program's `dispatch` spans (`parallel/engine.py`, one a slab: the step's
launches, each observable's host code and its host synchronisations)
over the traced passes of `program_trace`, over their batches."""

NAME, UNIT, BETTER, SOURCE = "issue_ms_per_batch.resident", "ms", "lower", "program_span"
LAYER = "parallel/engine.py resident loop (the step's host issue)"
MOVES = "resident_frames_per_s"


def read(ctx):
    if ctx.traffic["entry"] != "resident":
        return None
    from portbench import program_trace

    pt = program_trace.get(ctx)
    return None if pt is None else pt["issue_ms_per_batch"]
