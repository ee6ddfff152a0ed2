"""The program's own spans and counters (`groan_rs_tpu_torch.utils.profiling`)
over traced passes of a cell, lined up with a device trace.

Run once per traced run, after the window, by the first metric reader
that needs it (`get(ctx)`; the result is cached on `ctx`):

1. a resident cell loads its trajectory once more with tracing on (the
   program's `load_device` span; its `open`, `decode_wait`, `decode`,
   `ship` and `narrow` spans are printed), and drops that window;
2. `traced_passes` pairs of passes, one with the program's tracing off
   and one with it on, in turns (off first in even pairs): their medians
   are what tracing costs (the window's median is printed beside them);
3. `traced_passes` passes with the program's tracing on inside a device
   trace (`torch.profiler`, CUDA activity), between the marker kernels of
   `tracing.marker` that tie the trace's clock to `perf_counter`, the
   clock of the program's spans.  Before the first marker, `LEAD_EDGES`
   of `tracing._edge`'s small kernels and pauses: a profiler session
   that follows a large one (a triclinic pass: ~220,000 device events)
   has been seen to lose its first records.  Every idle gap of the
   device is named by the innermost of the program's main-thread spans
   it falls in (`tracing.read_trace` over all gaps, with a
   `tracing.Spans` of those spans): `open`, `decode_wait`, `stage`,
   `dispatch`, each `dispatch/<observable>`, `fetch`, `pass` (its self
   time), and `between spans` (outside every pass).  A trace that lost a
   marker is traced again, three tries, then the run fails, as the
   window's trace.

It prints the idle split and the cost of tracing to standard error.  A
program without tracing (no `profiling.tracing`) gives None, and so does
a run without a card: the metrics that read it are then left out.
"""

from __future__ import annotations

import os
import shutil
import statistics
import sys
import tempfile
import threading
import time

TRIES = 3
ALL_GAPS = 1 << 62   # `read_trace`'s `top`: every gap
LEAD_EDGES = 10      # `_edge` calls (50 ms each) before a trace's first marker


def get(ctx):
    """The program trace of run `ctx` (`harness.Run`), made on first use."""
    if not hasattr(ctx, "_program_trace"):
        ctx._program_trace = _make(ctx)
    return ctx._program_trace


def _profiling():
    try:
        from groan_rs_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "tracing") else None


def _make(ctx):
    profiling = _profiling()
    if profiling is None or not ctx.cuda:
        return None
    n = int(ctx.traffic.get("traced_passes", 1))
    saved = ctx.stage_totals, ctx.stage_batches   # a streamed pass adds its clocks there
    try:
        load = {}
        if ctx.traffic["entry"] == "resident":
            with profiling.tracing() as rec:
                dt = ctx.runner.load_device(ctx.xtc, batch_size=ctx.batch)
            del dt
            for s in rec.take()[0]:
                load[s.name] = load.get(s.name, 0.0) + s.seconds
        cost = {False: [], True: []}
        for i in range(n):
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                if on:
                    with profiling.tracing():
                        cost[on].append(_timed_pass(ctx))
                else:
                    cost[on].append(_timed_pass(ctx))
        out = _traced(ctx, profiling, n)
    finally:
        ctx.stage_totals, ctx.stage_batches = saved
    out["load_device_s"] = load.get("load_device")
    if load:
        print("program trace: load_device (s) by span: " + ", ".join(
            f"{k} {v:.4f}" for k, v in load.items()), file=sys.stderr)
    window_ms = statistics.median(t1 - t0 for t0, t1 in ctx.passes) * 1e3
    _report(out, cost, window_ms)
    return out


def _timed_pass(ctx) -> float:
    t0 = time.perf_counter()
    ctx.run_pass()
    ctx.sync()
    return time.perf_counter() - t0


def _traced(ctx, profiling, n: int) -> dict:
    """`n` passes with the program's tracing on inside a device trace ->
    `readings` of them."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.harness import BenchError
    from portbench.tracing import TraceTruncated, _edge, marker

    torch = ctx.torch
    for tries in range(1, TRIES + 1):
        tmp = tempfile.mkdtemp(prefix="portbench-program-")
        try:
            path = os.path.join(tmp, "trace.json")
            with profiling.tracing() as rec:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(LEAD_EDGES):
                        _edge(torch)
                    t_a = marker(torch)
                    passes = [_timed_pass(ctx) for _ in range(n)]
                    t_b = marker(torch)
                    _edge(torch)
            spans, counters = rec.take()
            prof.export_chrome_trace(path)
            try:
                info, split = idle_split(path, (t_a, t_b), spans, threading.get_ident())
            except TraceTruncated as e:
                print(f"program trace {tries} of {TRIES} not read: {e}", file=sys.stderr,
                      flush=True)
                if tries == TRIES:
                    raise BenchError(f"every program trace lost records ({e})") from e
                continue
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        out = readings(spans, counters, info, split)
        out["traced_pass_ms"] = [p * 1e3 for p in passes]
        return out


def idle_split(path: str, host_marks, spans, thread: int):
    """(`read_trace`'s result over every gap, {span name: idle seconds})
    of the trace at `path`; gaps named by the closed spans of `thread`."""
    from portbench.tracing import Spans, read_trace

    named = Spans()
    for s in spans:
        if s.thread == thread and s.t1 is not None:
            named.add(s.name, s.t0, s.t1)
    info = read_trace(path, host_marks, named, top=ALL_GAPS)
    split = {}
    for name, sec in info["idle_gaps"]:
        split[name] = split.get(name, 0.0) + sec
    return info, split


def readings(spans, counters, info, split) -> dict:
    """The per-layer numbers of traced passes from their spans, counters
    and the device trace's idle split."""
    def named(name):
        return [s for s in spans if s.name == name and s.t1 is not None]

    window = info["window_s"]
    dispatch, decode = named("dispatch"), named("decode")
    firsts = []
    for p in named("pass"):
        waits = [s for s in named("decode_wait") if s.pass_id == p.id]
        if waits:
            firsts.append(min(waits, key=lambda s: s.t0).t1 - p.t0)
    syncs = sum(v for (name, _), v in counters.items() if name == "host_sync")
    issue = sum(v for k, v in split.items() if k == "dispatch" or k.startswith("dispatch/"))
    host = {}
    for s in spans:
        if s.t1 is not None:
            host[s.name] = host.get(s.name, 0.0) + s.seconds
    return {
        "window_s": window,
        "idle_pct": 100.0 * (1.0 - info["busy_s"] / window),
        "split": split,
        "host_ms_per_pass": {k: 1e3 * v / max(1, len(named("pass"))) for k, v in host.items()},
        "issue_ms_per_batch": (1e3 * sum(s.seconds for s in dispatch) / len(dispatch)
                               if dispatch else None),
        "idle_in_issue_pct": 100.0 * issue / window,
        "syncs_per_batch": syncs / len(dispatch) if dispatch else None,
        "syncs_by_site": {site: v for (name, site), v in counters.items()
                          if name == "host_sync"},
        "first_batch_wait_ms": 1e3 * statistics.median(firsts) if firsts else None,
        "decode_ms_per_batch": (1e3 * sum(s.seconds for s in decode) / len(decode)
                                if decode else None),
        "idle_in_reader_pct": 100.0 * (split.get("open", 0.0)
                                       + split.get("decode_wait", 0.0)) / window,
    }


def _report(out: dict, cost: dict, window_ms: float) -> None:
    w = out["window_s"]
    parts = ", ".join(f"{k} {v * 1e3:.3f} ms ({100 * v / w:.3f}%)"
                      for k, v in sorted(out["split"].items(), key=lambda kv: -kv[1]))
    print(f"program trace: idle {out['idle_pct']:.3f}% of {w:.4f} s, by span: {parts}",
          file=sys.stderr)
    host = ", ".join(f"{k} {v:.3f}" for k, v in sorted(out["host_ms_per_pass"].items(),
                                                        key=lambda kv: -kv[1]))
    print(f"program trace: host ms a pass by span: {host}", file=sys.stderr)
    print(f"program trace: host_sync by site {out['syncs_by_site']}", file=sys.stderr)
    off, on = (statistics.median(cost[k]) * 1e3 for k in (False, True))
    print(f"program trace: passes in turns (medians of {len(cost[True])}) with tracing off "
          f"{off:.3f} ms, on {on:.3f} ms: tracing costs {100 * (on / off - 1):+.3f}%; "
          f"the window's median pass {window_ms:.3f} ms ({100 * (on / window_ms - 1):+.3f}%); "
          f"with tracing and the device trace (median) "
          f"{statistics.median(out['traced_pass_ms']):.3f} ms", file=sys.stderr, flush=True)
