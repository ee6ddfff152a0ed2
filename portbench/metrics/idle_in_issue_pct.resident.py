"""Share of the traced window the device sits idle while the host issues
a resident batch: idle gaps of the device trace named by the program's
`dispatch` span or one of its `dispatch/<observable>` children
(`program_trace`), as a % of the traced window."""

NAME, UNIT, BETTER, SOURCE = "idle_in_issue_pct.resident", "%", "lower", "device_trace"
LAYER = "parallel/engine.py resident loop (the step's host issue)"
MOVES = "resident_frames_per_s"


def read(ctx):
    if ctx.traffic["entry"] != "resident":
        return None
    from portbench import program_trace

    pt = program_trace.get(ctx)
    return None if pt is None else pt["idle_in_issue_pct"]
