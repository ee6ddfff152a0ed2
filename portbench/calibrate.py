#!/usr/bin/env python3
"""The two readings each limit of a cell is set from.

    python3 portbench/calibrate.py --workload main-resident \
        --seeds 11,12,13 --control-seeds 21,22,23 [--seconds 1] [--out PATH]

From the root of a checkout on a machine with a CUDA card.  For each of
`--seeds` it makes one short run of the cell (the harness's own set-up,
window and comparison, `--seconds` long) and records every number the
comparison reads: their largest over the seeds is the lower reading.  For
each of `--control-seeds` it puts the control in the program's place: the
plain reference computed in the nearest precision below the one the
configuration states (float32 with TF32 off, so TF32: every input rounded
to TF32, float32 arithmetic), judged by the same comparison; the smallest
over the seeds is the upper reading.  The benchmark's own runs never run
the control.  Prints one JSON object; `--out` also writes it there.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_numbers(config, traffic, seed, device) -> dict:
    """The comparison's numbers of the control on seed `seed`, over the
    frames a run compares."""
    import torch

    from portbench import harness
    from portbench.reference.frames import Frames
    from portbench.reference.judge import control_outputs, judge_block
    from portbench.reference.plain import to_tf32

    syn = harness.make_system(config, seed, device, n_frames=int(traffic["frames"]))
    analysis = traffic["analysis"]
    numbers = {}
    for ids, p in harness.reference_blocks(syn, traffic, seed):
        ctl = Frames(syn, p, torch.float32, round_inputs=to_tf32, analysis=analysis)
        got = control_outputs(ctl, analysis)
        del ctl
        judge_block(got, Frames(syn, p, torch.float64, analysis=analysis),
                    analysis, numbers)
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from portbench import harness

    cell, config, traffic = harness.resolve_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    report = {"workload": args.workload, "program": {}, "control": {}}
    for s in seeds:
        t0 = time.perf_counter()
        res = harness.run_cell(cell, config, traffic, s, args.seconds, False,
                               args.device, t0, None)
        run = res.pop("_run")
        report["program"][str(s)] = {k: v["value"] for k, v in res["checks"].items()}
        print(f"program seed {s}: {report['program'][str(s)]} ({len(run.passes)} passes, "
              f"setup {run.setup_s:.1f} s, reference {res['_reference_s']:.1f} s)",
              file=sys.stderr, flush=True)
        del run, res
    for s in cseeds:
        t0 = time.perf_counter()
        report["control"][str(s)] = control_numbers(config, traffic, s, args.device)
        print(f"control seed {s}: {report['control'][str(s)]} "
              f"({time.perf_counter() - t0:.1f} s)", file=sys.stderr, flush=True)
    keys = sorted({k for v in list(report["program"].values())
                   + list(report["control"].values()) for k in v})
    report["lower"] = {k: max((v[k] for v in report["program"].values()), default=None)
                       for k in keys}
    report["upper"] = {k: min((v[k] for v in report["control"].values()), default=None)
                       for k in keys}
    text = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
