"""Share of the traced window the device sits idle inside the hydrogen-bond
cell path: idle gaps of the device trace named by the program's `hbond`
span or one of its `hbond/<step>` children (`program_trace`), as a % of
the traced window.  A program without those spans reads nothing."""

NAME, UNIT, BETTER, SOURCE = "idle_in_hbond_pct.streamed", "%", "lower", "device_trace"
LAYER = "system/hbonds.py hydrogen-bond cell path (host walk, rank wire, device scorer)"
MOVES = "streamed_frames_per_s"


def _hbond(name: str) -> bool:
    return name == "hbond" or name.startswith("hbond/")


def read(ctx):
    if ctx.traffic["entry"] != "streamed":
        return None
    from portbench import program_trace

    pt = program_trace.get(ctx)
    if pt is None or "hbond" not in pt["host_ms_per_pass"]:
        return None
    idle = sum(v for k, v in pt["split"].items() if _hbond(k))
    return 100.0 * idle / pt["window_s"]
