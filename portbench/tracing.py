"""The benchmark's own spans and its reading of the device trace.

Spans are host-clock intervals the harness opens around each call into
a layer of the program (set-up steps, `load_device`, each pass).  The
traced run records the device with `torch.profiler` (CUDA activity only:
a triclinic pass launches ~10^5 kernels, and host-side events make the
post-processing take minutes) over a steady part of the window, exports
the Chrome trace under TMPDIR and reads it here: the union of device
intervals (kernels, copies, memsets) is the busy time, so overlapping
streams are not counted twice; the gaps between them are the idle time.
A marker kernel (`torch.cuda._sleep`) launched on an idle device right
after a host clock reading ties the trace's clock to the host's, so each
idle gap is named by the benchmark span it falls in.  Small kernels and a
pause lie between each marker and the trace's edge, outside the window:
the profiler has been seen to lose one record at an edge.  A trace that holds
fewer than its two markers has lost records: it is refused
(`TraceTruncated`), never read, since the kernels it lost would count as
idle time.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"
EDGE_S = 0.05     # host seconds between the profiler's start or stop and a marker


class TraceTruncated(RuntimeError):
    """A trace that lost records (a marker kernel is missing)."""


class Spans:
    """Named host-clock intervals (seconds of `time.perf_counter`)."""

    def __init__(self):
        self.items = []   # (name, t0, t1)

    @contextmanager
    def span(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync()
            self.items.append((name, t0, time.perf_counter()))

    def add(self, name: str, t0: float, t1: float) -> None:
        self.items.append((name, t0, t1))

    def seconds(self, name: str) -> float | None:
        got = [t1 - t0 for n, t0, t1 in self.items if n == name]
        return sum(got) if got else None

    def at(self, t: float) -> str:
        """The innermost (latest-opened) span holding host time `t`."""
        best = None
        for n, t0, t1 in self.items:
            if t0 <= t <= t1 and (best is None or t0 >= best[1]):
                best = (n, t0)
        return best[0] if best else "between spans"


def marker(torch) -> float:
    """Host time (perf_counter seconds) of a marker kernel's launch on an
    idle device."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    return t


def _edge(torch) -> None:
    """Small kernels that are no markers, then an idle pause, at an edge of
    a trace: where the profiler loses the first or last record of a trace,
    or the first moments, it loses these and not a marker."""
    x = torch.zeros(4, device=torch.device("cuda", torch.cuda.current_device()))
    x.add_(1.0)
    torch.cuda.synchronize()
    time.sleep(EDGE_S)


def read_trace(path: str, host_marks: tuple[float, float], spans: Spans,
               top: int = 10) -> dict:
    """Busy time, window, top device operations and the longest idle gaps
    of the Chrome trace `path`, between its two marker kernels."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    marks = sorted(e["ts"] for e in dev if MARKER in e.get("name", ""))
    if len(marks) != 2:
        ts = [float(e["ts"]) for e in dev]
        at = ", ".join(f"{100 * (m - min(ts)) / max(max(ts) - min(ts), 1e-9):.1f}%"
                       for m in marks)
        raise TraceTruncated(f"the trace holds {len(marks)} marker kernels of 2 "
                             f"({len(dev)} device events; markers at {at or 'none'} "
                             f"of their span)")
    lo_us, hi_us = marks
    offset_s = lo_us * 1e-6 - host_marks[0]          # trace clock - host clock
    ivs = []
    by_name = {}
    for e in dev:
        if MARKER in e.get("name", ""):
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        a, b = max(a, lo_us), min(b, hi_us)
        if b <= a:
            continue
        ivs.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
    ivs.sort()
    merged = []
    for a, b in ivs:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_us = sum(b - a for a, b in merged)
    gaps, prev = [], lo_us
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if hi_us > prev:
        gaps.append((prev, hi_us))
    gaps.sort(key=lambda g: g[0] - g[1])
    # a gap is named by the span its middle falls in
    idle = [[spans.at((a + b) * 0.5e-6 - offset_s), (b - a) * 1e-6] for a, b in gaps[:top]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_us * 1e-6, "window_s": (hi_us - lo_us) * 1e-6,
            "device_ops": [[k, v] for k, v in ops], "idle_gaps": idle,
            "events": len(ivs)}


@contextmanager
def profiled(torch, spans: Spans, into: dict, tmpdir: str):
    """Profile the device over the block; fill `into` with `read_trace`'s
    result once it closes."""
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(tmpdir, "trace.json")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _edge(torch)
        t_a = marker(torch)
        yield
        t_b = marker(torch)
        _edge(torch)
    prof.export_chrome_trace(path)
    into.update(read_trace(path, (t_a, t_b), spans))
    os.unlink(path)
