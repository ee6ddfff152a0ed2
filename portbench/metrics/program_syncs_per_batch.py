"""Host synchronisations a resident batch makes, counted by the program:
its `host_sync` counter (every site that makes the host wait for the
card: QCP's `eigh`, the packed fetch's copy, ...) over the traced passes
of `program_trace`, over their batches."""

NAME, UNIT, BETTER, SOURCE = "program_syncs_per_batch", "count", "lower", "program_counter"
LAYER = "parallel/engine.py resident loop"
MOVES = "resident_frames_per_s"


def read(ctx):
    if ctx.traffic["entry"] != "resident":
        return None
    from portbench import program_trace

    pt = program_trace.get(ctx)
    return None if pt is None else pt["syncs_per_batch"]
