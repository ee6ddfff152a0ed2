"""The program trace (`program_trace.py`): the device's idle gaps named by
the program's own spans, the readings of the seven metrics that read it,
and on the card the program's `host_sync` count against the syncs that
`torch.cuda.set_sync_debug_mode` sees."""

import json
import threading
import types
import warnings

import pytest

from portbench import harness, program_trace
from portbench.conftest import tiny

ev = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}
MARK = "at::cuda::spin_kernel(long)"
HOST0 = 5.0   # host clock of the first marker's launch (trace time 1000 us)


def _h(us):
    """Host time of trace time `us`."""
    return HOST0 + (us - 1000.0) * 1e-6


def _program_spans():
    """A streamed pass of one batch as the program records it: `open`,
    `decode_wait`, `stage`, `dispatch` with one observable, the closing
    `decode_wait`, `fetch`; a `decode` on the prefetch thread."""
    from groan_rs_tpu_torch.utils import profiling as P

    with P.tracing() as rec:
        p = P.begin("pass", _h(1100))
        P.add("open", _h(1100), _h(1200))
        P.add("decode_wait", _h(1200), _h(1400), batch=0)
        P.add("stage", _h(1400), _h(1500), batch=0)
        d = P.begin("dispatch", _h(1500), batch=0, frames=4)
        P.add("dispatch/com", _h(1600), _h(1900))
        P.end(d, _h(2200))
        P.add("decode_wait", _h(2200), _h(2300), batch=1)
        P.add("fetch", _h(2300), _h(2600))
        t = threading.Thread(target=lambda: P.add("decode", _h(1050), _h(1300), parent=p))
        t.start()
        t.join(timeout=10)
        P.end(p, _h(2900))
        P.count("host_sync", "rmsd.eigh")
        P.count("host_sync", "fetch.copy")
    return rec.take()


def _trace(tmp_path):
    # busy 1050-1100 (outside the pass), 1200-1210, 1450-1480 (stage),
    # 1700-1750 (dispatch/com), 1850-1900, 1950-2000 (dispatch), 2500-2600
    events = [ev(MARK, 1000.0, 1.0), ev("k", 1050.0, 50.0), ev("k", 1200.0, 10.0),
              ev("k", 1450.0, 30.0), ev("k", 1700.0, 50.0), ev("k", 1850.0, 50.0),
              ev("k", 1950.0, 50.0), ev("k", 2500.0, 100.0), ev(MARK, 3000.0, 1.0)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_idle_split_by_program_span(tmp_path):
    spans, counters = _program_spans()
    info, split = program_trace.idle_split(_trace(tmp_path), (HOST0, _h(3000)), spans,
                                           threading.get_ident())
    us = {k: round(v * 1e6, 6) for k, v in split.items()}
    # the prefetch thread's decode names no gap; `pass` is its self time
    assert us == {"between spans": 50.0, "open": 100.0, "decode_wait": 240.0 + 500.0,
                  "dispatch": 220.0 + 50.0, "dispatch/com": 100.0, "pass": 400.0}
    assert sum(split.values()) == pytest.approx(info["window_s"] - info["busy_s"])
    got = program_trace.readings(spans, counters, info, split)
    assert got["idle_pct"] == pytest.approx(83.0)
    assert got["idle_in_issue_pct"] == pytest.approx(100 * 370 / 2000)
    assert got["idle_in_reader_pct"] == pytest.approx(100 * 840 / 2000)
    parts = sum(100 * v / info["window_s"] for v in split.values())
    assert parts == pytest.approx(got["idle_pct"])
    assert got["issue_ms_per_batch"] == pytest.approx(0.7)
    assert got["first_batch_wait_ms"] == pytest.approx(0.3)
    assert got["decode_ms_per_batch"] == pytest.approx(0.25)
    assert got["syncs_per_batch"] == 2.0
    assert got["syncs_by_site"] == {"rmsd.eigh": 1, "fetch.copy": 1}
    host = got["host_ms_per_pass"]
    assert host["pass"] == pytest.approx(1.8) and host["decode_wait"] == pytest.approx(0.3)
    assert host["decode"] == pytest.approx(0.25) and host["dispatch/com"] == pytest.approx(0.3)


READERS = {"issue_ms_per_batch.resident": ("resident", "issue_ms_per_batch"),
           "idle_in_issue_pct.resident": ("resident", "idle_in_issue_pct"),
           "program_syncs_per_batch": ("resident", "syncs_per_batch"),
           "load_device_s.program": ("resident", "load_device_s"),
           "first_batch_wait_ms.streamed": ("streamed", "first_batch_wait_ms"),
           "decode_ms_per_batch.streamed": ("streamed", "decode_ms_per_batch"),
           "idle_in_reader_pct.streamed": ("streamed", "idle_in_reader_pct")}


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_reads_its_number(name):
    entry, key = READERS[name]
    mod = harness.metric_reader(name)
    trace = {k: float(i + 1) for i, k in enumerate(v for _, v in READERS.values())}
    for e in ("resident", "streamed"):
        ctx = types.SimpleNamespace(traffic={"entry": e}, _program_trace=trace)
        assert mod.read(ctx) == (trace[key] if e == entry else None)


def test_no_card_or_no_program_tracing_reads_nothing(monkeypatch):
    """A run without a card, and a program without tracing (a parent
    commit), give no program trace and no error."""
    ctx = types.SimpleNamespace(cuda=False, traffic={"entry": "resident"})
    assert program_trace.get(ctx) is None and ctx._program_trace is None
    monkeypatch.setattr(program_trace, "_profiling", lambda: None)
    ctx = types.SimpleNamespace(cuda=True, traffic={"entry": "streamed"})
    assert harness.metric_reader("idle_in_reader_pct.streamed").read(ctx) is None


def _sync_debug(torch, fn):
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in got)


@pytest.mark.card
def test_host_sync_counts_what_sync_debug_sees(cuda_card, tmp_path, monkeypatch):
    """Over one resident pass (K1-K3, QCP, the packed fetch), the program's
    `host_sync` equals the warnings of `set_sync_debug_mode("warn")`, and
    tracing adds no synchronisation of its own."""
    import torch

    from groan_rs_tpu_torch.ops import distances
    from groan_rs_tpu_torch.utils import profiling

    monkeypatch.setattr(distances, "_PAIR_TILE_THRESHOLD", 1)   # K3 at this size
    # the first call of a process warns that the mode is a prototype, which
    # is no synchronisation: it is made here, outside the counts
    torch.cuda.set_sync_debug_mode(0)
    cell, config, traffic = tiny("main-resident", n=30000, frames=16, batch=4)
    run = harness.Run(cell, config, traffic, 2**31 + 3, 1.0, False, cuda_card)
    harness.setup(run, str(tmp_path))
    try:
        off = _sync_debug(torch, run.run_pass)
        with profiling.tracing() as rec:
            on = _sync_debug(torch, run.run_pass)
        spans, counters = rec.take()
    finally:
        harness.free_program(run)
    assert [s.attrs["route"] for s in spans if s.name == "pass"] == ["resident_fused"]
    syncs = {site: n for (name, site), n in counters.items() if name == "host_sync"}
    assert on == off and sum(syncs.values()) == on, (on, off, syncs)
