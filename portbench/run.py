#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload main-resident --seed 7 --seconds 30 --trace 0

From the root of a checkout on a machine with CUDA cards.  The last line
of standard output is one JSON object (`correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` `breakdown`, and last `checks`:
each number the comparison read beside its limit); the last lines of
standard error repeat the checks.  A run exits non-zero and prints no
result when there is no card (or fewer than the cell asks for), when a
module of JAX or the JAX package is loaded, or when anything fails.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    try:
        cell, config, traffic = harness.resolve_cell(args.workload)
        bench = harness.benchmark(".")
        import torch

        chips = int(cell.get("chips", 1))
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise harness.BenchError(
                f"the cell needs {chips} CUDA card(s); torch sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        result = harness.run_cell(cell, config, traffic, args.seed, args.seconds,
                                  bool(args.trace), "cuda:0", T_START, bench)
    except harness.BenchError as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 2
    # after the run: the card's name and power limit, outside the set-up
    print(f"card: {harness.card_line()}", file=sys.stderr, flush=True)
    emit(result)
    return 0


def emit(result: dict) -> None:
    """The stderr summary, then the result line as the last stdout line."""
    run = result.pop("_run")
    ref_s = result.pop("_reference_s")
    print(f"setup_s {run.setup_s:.4f}; input write {run.write_s:.4f} s; window "
          f"{run.window_s:.4f} s, {len(run.passes)} passes; reference {ref_s:.4f} s",
          file=sys.stderr)
    if run.trace_info:
        print(f"trace: {run.trace_info['events']} device events, busy "
              f"{run.trace_info['busy_s']:.4f} s of {run.trace_info['window_s']:.4f} s",
              file=sys.stderr)
    steps = [f"{n} {t1 - t0:.3f}" for n, t0, t1 in run.spans.items if n != "pass"]
    print(f"set-up spans (s): {', '.join(steps)}", file=sys.stderr)
    ms = sorted((t1 - t0) * 1e3 for t0, t1 in run.passes)
    half = len(run.passes) // 2
    if half:
        rate = [run.frames * len(p) / (p[-1][1] - p[0][0])
                for p in (run.passes[:half], run.passes[half:])]
        print(f"pass ms: min {ms[0]:.3f}, median {ms[len(ms) // 2]:.3f}, max {ms[-1]:.3f}; "
              f"frames/s in the window's halves {rate[0]:.2f}, {rate[1]:.2f}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
