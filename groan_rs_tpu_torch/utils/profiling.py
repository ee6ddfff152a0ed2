"""Pipeline profiling and the port's in-memory tracing.

Port of `groan_rs_tpu/utils/profiling.py`:

- `PipelineProfiler`: per-stage wall-clock accounting of the streamed
  pass, collected per batch and summarised; attach it to
  `FrameEngine.run(profiler=...)` or `PipelineRunner.run(profiler=...)`.
  The engine records each batch with its own stage clocks
  (`record_batch`); code that profiles by hand uses the JAX package's
  protocol, `start_batch` / `with stage(name)` / `end_batch`, which
  fills the same records (a JAX stage name is recorded under the port's).
  The port's stages are `decode_wait` (blocked on the reader), `stage`
  (pinned fill and the host-to-device copy; the JAX package's `h2d`) and
  `dispatch` (the step and its fold; the JAX package's `compute`).  A
  profiled pass synchronises each batch's copy and compute, so each stage
  holds its device time; that changes the schedule it measures (the
  engine's own `last_stage_seconds` clocks the unsynchronised pass).
- `trace(log_dir)`: a context manager around `torch.profiler` (CPU, and
  CUDA when a card is present) that writes a Chrome trace of the wrapped
  region into `log_dir` (TensorBoard or Perfetto read it).

Tracing (the port's own spans and counters, no JAX counterpart):

    from groan_rs_tpu_torch.utils import profiling

    with profiling.tracing() as rec:
        runner.run(xtc)
    spans, counters = rec.take()

- It is off unless a `tracing()` block is open; no environment variable
  switches it.  Off, each site in the port costs one check of the
  module-level flag `TRACING` and records nothing.  On, a span is a
  `Span` (name, start, end, thread, parent span id, pass id, attributes)
  and a counter one `(name, site) -> count` entry of `rec.counters`;
  both stay in memory until `rec.take()` hands them over.  Recording makes
  no host synchronisation: a span is the host's time around a call, and
  a span that launches device work ends when the launch returns.
- Times are `time.perf_counter()` seconds, the clock of the readings
  `FrameEngine.last_stage_seconds` keeps (a span and that clock share
  their two readings).  To line the spans up with a `torch.profiler`
  trace, launch a marker kernel on an idle device right after a
  `perf_counter()` reading (`torch.cuda.synchronize()`, read the clock,
  `torch.cuda._sleep(n)`, synchronise): the marker's start in the trace
  minus that reading is the offset from host time to trace time.
- A span's parent is the span open on its thread when it opened; the
  reader's prefetch thread takes the span open where its loader was made.
  Its pass id is the id of the outermost span above it (`pass`, or
  `load_device`).
- Spans: `pass` (`PipelineRunner.run`; route, frames, batch size), `open`
  (the reader's construction; the one-shot size check), `decode` (one
  batch's decode, on the prefetch thread), `decode_wait`, `stage`,
  `dispatch` (with a child `dispatch/<observable>` per observable of the
  step), `fetch` (the packed fetch), `load_device` with `decode_wait`,
  `ship` and `narrow` under it; `hbond` (batch, frames; the cell method's
  work on each streamed batch, `PipelineRunner.run`'s `on_batch`) with
  `hbond/walk` (the candidate walk and packing), `hbond/ship` (the rank
  copy), `hbond/score` (the device scorer and its copies back) and
  `hbond/rescore` (the host re-score of guarded triples) under it, from
  `HBondAnalysis.analyze_batch`.  Counters: `host_sync`, per site, each
  time a call that makes the host wait for the device is passed, on any
  device; `hbond_candidates` and `hbond_guarded` (site `analyze_batch`),
  a batch's candidate pairs and guarded triples.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import statistics
import threading
import time

__all__ = ["PipelineProfiler", "Recorder", "Span", "trace", "tracing"]

# True only inside a `tracing()` block: the one check each site makes
TRACING = False
_rec = None  # the open block's Recorder


class PipelineProfiler:
    """Accumulates per-stage timings of the trajectory pipeline."""

    STAGES = ("decode_wait", "stage", "dispatch")
    # the JAX package's name of each stage
    JAX_NAMES = {"decode_wait": "decode_wait", "stage": "h2d", "dispatch": "compute"}

    def __init__(self):
        self.batches: list[dict] = []
        self._open: dict | None = None

    # ------------------------------------------------------------- recording
    def record_batch(self, n_frames: int, stages: dict):
        """One batch's stage seconds, measured by its caller (the engine's
        own clocks)."""
        self.batches.append({"n_frames": int(n_frames), **stages})

    def start_batch(self, n_frames: int):
        """Open a batch whose stages `stage` then clocks."""
        self._open = {"n_frames": int(n_frames)}

    @contextlib.contextmanager
    def stage(self, name: str):
        """Add the wrapped region's seconds to the open batch's stage
        `name` (a port name, or the JAX package's: "h2d", "compute")."""
        name = _PORT_NAMES.get(name, name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._open is not None:
                self._open[name] = self._open.get(name, 0.0) + (
                    time.perf_counter() - t0)

    def end_batch(self):
        """Close the open batch into `batches`."""
        if self._open is not None:
            self.batches.append(self._open)
            self._open = None

    # ------------------------------------------------------------- reporting
    def totals(self) -> dict:
        out = {s: 0.0 for s in self.STAGES}
        out["n_frames"] = 0
        for b in self.batches:
            out["n_frames"] += b.get("n_frames", 0)
            for s in self.STAGES:
                out[s] += b.get(s, 0.0)
        return out

    def medians(self) -> dict:
        """Per-stage per-batch medians (seconds): one stalled batch moves a
        total, not a median."""
        out = {}
        for s in self.STAGES:
            vals = [b[s] for b in self.batches if s in b]
            out[s] = statistics.median(vals) if vals else 0.0
        out["n_batches"] = len(self.batches)
        return out

    def summary(self) -> str:
        t = self.totals()
        n = max(t["n_frames"], 1)
        parts = [f"{len(self.batches)} batches, {t['n_frames']} frames"]
        for s in self.STAGES:
            jax_name = self.JAX_NAMES[s]
            name = s if jax_name == s else f"{jax_name} ({s})"
            parts.append(f"{name}: {t[s]*1e3:.1f} ms ({t[s]/n*1e3:.2f} ms/frame)")
        return " | ".join(parts)


_PORT_NAMES = {v: k for k, v in PipelineProfiler.JAX_NAMES.items()}


@contextlib.contextmanager
def trace(log_dir):
    """Profile the wrapped region with `torch.profiler` and write its
    Chrome trace (`*.pt.trace.json`) into `log_dir`; yields the profiler."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof


# ------------------------------------------------------------------ tracing
class Span:
    """One host-clock interval of the port (perf_counter seconds); `t1`
    is None while it is open."""

    __slots__ = ("id", "name", "t0", "t1", "thread", "parent", "pass_id", "attrs")

    def __init__(self, sid, name, t0, t1, parent, attrs):
        self.id = sid
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.thread = threading.get_ident()
        self.parent = None if parent is None else parent.id
        self.pass_id = sid if parent is None else parent.pass_id
        self.attrs = attrs

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def __repr__(self) -> str:
        return (f"Span({self.id} {self.name!r} {self.t0:.6f}-{self.t1} parent "
                f"{self.parent} pass {self.pass_id} {self.attrs})")


class Recorder:
    """The spans (in the order they opened) and counters of one
    `tracing()` block."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict = {}   # (name, site) -> count
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()  # each thread's stack of open spans

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def take(self):
        """-> (spans, counters) recorded so far; the recorder starts empty."""
        with self._lock:
            out = self.spans, self.counters
            self.spans, self.counters = [], {}
        return out


@contextlib.contextmanager
def tracing():
    """Record the port's spans and counters inside the block; yields the
    `Recorder`.  Blocks nest: an inner block records alone, and the outer
    one records again after it."""
    global TRACING, _rec
    prev = TRACING, _rec
    rec = Recorder()
    _rec, TRACING = rec, True
    try:
        yield rec
    finally:
        TRACING, _rec = prev


def current():
    """The innermost span open on this thread (None without one)."""
    rec = _rec
    if rec is None:
        return None
    st = rec._stack()
    return st[-1] if st else None


def begin(name: str, t0: float | None = None, **attrs):
    """Open span `name` on this thread, under the span open there; -> the
    Span, or None when tracing is off."""
    rec = _rec
    if rec is None:
        return None
    st = rec._stack()
    s = Span(next(rec._ids), name, time.perf_counter() if t0 is None else t0, None,
             st[-1] if st else None, attrs)
    st.append(s)
    with rec._lock:
        rec.spans.append(s)
    return s


def end(span, t1: float | None = None) -> None:
    """Close `span` (a Span from `begin`, or None); a child that an
    exception left open closes with it."""
    if span is None:
        return
    span.t1 = time.perf_counter() if t1 is None else t1
    rec = _rec
    st = rec._stack() if rec is not None else []
    while span in st:
        top = st.pop()
        if top.t1 is None:
            top.t1 = span.t1


def add(name: str, t0: float, t1: float, parent=None, **attrs):
    """A closed span from two readings already taken, under `parent` (by
    default the span open on this thread) -> the Span, or None when
    tracing is off."""
    rec = _rec
    if rec is None:
        return None
    if parent is None:
        parent = current()
    s = Span(next(rec._ids), name, t0, t1, parent, attrs)
    with rec._lock:
        rec.spans.append(s)
    return s


class _Open:
    """`with span(...)`: begin on entry, end on exit."""

    __slots__ = ("name", "attrs", "span")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.span = begin(self.name, **self.attrs)
        return self.span

    def __exit__(self, *exc):
        end(self.span)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """`with span(name, **attrs) as s:` records the block as a span (`s`
    the Span, None when tracing is off)."""
    return _OFF if not TRACING else _Open(name, attrs)


def count(name: str, site: str, n: int = 1) -> None:
    """Add `n` to counter `name` at `site` (nothing when tracing is off)."""
    rec = _rec
    if rec is None:
        return
    with rec._lock:
        rec.counters[(name, site)] = rec.counters.get((name, site), 0) + n


def waits(iterable, name: str = "decode_wait"):
    """`iterable`'s items, each `next()` recorded as span `name` (the
    closing one that finds it exhausted too)."""
    it = iter(iterable)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            add(name, t0, time.perf_counter())
            return
        add(name, t0, time.perf_counter())
        yield item
