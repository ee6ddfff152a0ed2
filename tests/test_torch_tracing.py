"""The port's in-memory tracing (`utils/profiling.py` `tracing`, its spans
and the `host_sync` counter at the sites of the engine, the runner, the
reader and the step) on the CPU: what a streamed, a resident, a one-shot
pass and a load record, that each child lies inside its parent, that the
spans share the engine's clock readings, that results do not change with
tracing on, and that nothing is recorded with it off."""

import sys
import threading

import numpy as np
import pytest

from groan_rs_tpu_torch import convert, testing
from groan_rs_tpu_torch.io import native
from groan_rs_tpu_torch.models import TrajectoryAnalysis
from groan_rs_tpu_torch.utils import profiling
from groan_rs_tpu_torch.utils.profiling import PipelineProfiler

N_ATOMS, N_FRAMES, BATCH = 1200, 10, 3
N_BATCHES = -(-N_FRAMES // BATCH)
OBSERVABLES = ("com", "rmsd", "mindist")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tracing") / "s.xtc")
    testing.build_trajectory(path, N_ATOMS, N_FRAMES)
    offs, _, _, nat = native.xtc_scan(path)
    x, b9, *_ = native.xtc_read_frames(path, offs[:1], nat)
    system = convert.system_from_state(testing.synthetic_state(x[0], b9[0][[0, 4, 8]]),
                                       device="cpu")
    return path, system


def _pipe(system):
    return (TrajectoryAnalysis(system, device="cpu").add_com("Protein", name="com")
            .add_rmsd("Protein", system, name="rmsd")
            .add_min_distance("Peptide", "Membrane", name="mindist"))


def _traced(fn):
    with profiling.tracing() as rec:
        out = fn()
    spans, counters = rec.take()
    return out, spans, counters


def _named(spans, name):
    return [s for s in spans if s.name == name]


def _syncs(counters):
    return {site: n for (name, site), n in counters.items() if name == "host_sync"}


def _nested(spans):
    """Every span is closed and lies inside its parent, on its pass."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.t1 is not None and s.t0 <= s.t1, s
        if s.parent is None:
            assert s.pass_id == s.id
            continue
        p = by_id[s.parent]
        assert p.t0 <= s.t0 and s.t1 <= p.t1, (s, p)
        assert s.pass_id == p.pass_id


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k


def test_streamed_pass_records_its_spans(case, monkeypatch):
    path, system = case
    monkeypatch.setenv("GROAN_ONESHOT_BYTES", "0")
    runner = _pipe(system).runner()
    _, spans, counters = _traced(lambda: runner.run(path, batch_size=BATCH))
    _nested(spans)
    (p,) = _named(spans, "pass")
    assert p.parent is None and p.attrs == {"batch_size": BATCH, "route": "streamed",
                                            "frames": N_FRAMES}
    main = threading.get_ident()
    assert {s.thread for s in spans if s.name != "decode"} == {main}
    for name in ("open", "decode_wait", "stage", "dispatch", "fetch"):
        assert all(s.parent == p.id for s in _named(spans, name)), name
    # one wait per batch, and the read that finds the reader at its end
    assert [s.attrs["batch"] for s in _named(spans, "decode_wait")] == list(
        range(N_BATCHES + 1))
    assert [s.attrs["batch"] for s in _named(spans, "stage")] == list(range(N_BATCHES))
    dispatch = _named(spans, "dispatch")
    assert [s.attrs["batch"] for s in dispatch] == list(range(N_BATCHES))
    assert [s.attrs["frames"] for s in dispatch] == [3, 3, 3, 1]
    for d in dispatch:
        kids = [s for s in spans if s.parent == d.id]
        assert [s.name for s in kids] == [f"dispatch/{o}" for o in OBSERVABLES]
    assert len(_named(spans, "fetch")) == 1
    decode = _named(spans, "decode")
    assert len(decode) == N_BATCHES and sum(s.attrs["frames"] for s in decode) == N_FRAMES
    assert all(s.thread != main and s.parent == p.id for s in decode)
    # the first two batches build the two staging slots, the rest reuse them
    assert _syncs(counters) == {"rmsd.eigh": N_BATCHES, "engine.slot_reuse": N_BATCHES - 2,
                                "fetch.copy": 1}


def test_spans_share_the_engine_clock_readings(case, monkeypatch):
    path, system = case
    monkeypatch.setenv("GROAN_ONESHOT_BYTES", "0")
    runner = _pipe(system).runner()
    prof = PipelineProfiler()
    _, spans, _ = _traced(lambda: runner.run(path, batch_size=BATCH, profiler=prof))
    clocks = runner.engine.last_stage_seconds
    for name in ("decode_wait", "stage", "dispatch"):
        assert [s.t1 - s.t0 for s in _named(spans, name)] == clocks[name], name
    # the profiler gets the same readings, batch by batch
    assert len(prof.batches) == N_BATCHES
    for i, b in enumerate(prof.batches):
        assert {k: b[k] for k in PipelineProfiler.STAGES} == {
            k: clocks[k][i] for k in PipelineProfiler.STAGES}


def test_profiled_pass_counts_its_waits(case, monkeypatch):
    path, system = case
    monkeypatch.setenv("GROAN_ONESHOT_BYTES", "0")
    runner = _pipe(system).runner()
    _, _, counters = _traced(lambda: runner.run(path, batch_size=BATCH,
                                                profiler=PipelineProfiler()))
    assert _syncs(counters) == {"rmsd.eigh": N_BATCHES, "engine.slot_reuse": N_BATCHES - 2,
                                "engine.profiler_copy": N_BATCHES,
                                "engine.profiler_compute": N_BATCHES, "fetch.copy": 1}


@pytest.mark.parametrize("fused", ["1", "0"])
def test_resident_pass_records_slabs_and_syncs(case, monkeypatch, fused):
    path, system = case
    monkeypatch.setenv("GROAN_RESIDENT_FUSED", fused)
    runner = _pipe(system).runner()
    dt = runner.load_device(path, batch_size=BATCH)
    got = []
    for _ in range(2):
        _, spans, counters = _traced(lambda: runner.run(dt, batch_size=BATCH))
        _nested(spans)
        (p,) = _named(spans, "pass")
        assert p.attrs["route"] == ("resident_fused" if fused == "1" else "resident")
        dispatch = _named(spans, "dispatch")
        assert len(dispatch) == N_BATCHES and len(_named(spans, "fetch")) == 1
        assert [s.attrs["frames"] for s in dispatch] == [3, 3, 3, 1]
        assert all(s.parent == p.id for s in dispatch)
        assert [s.name for s in spans if s.parent == dispatch[0].id] == [
            f"dispatch/{o}" for o in OBSERVABLES]
        got.append(_syncs(counters))
    assert got[0] == got[1] == {"rmsd.eigh": N_BATCHES, "fetch.copy": 1}


def test_load_device_records_its_steps(case):
    path, system = case
    runner = _pipe(system).runner()
    dt, spans, counters = _traced(lambda: runner.load_device(path, batch_size=BATCH))
    _nested(spans)
    (load,) = _named(spans, "load_device")
    assert load.parent is None
    main = [s for s in spans if s.thread == threading.get_ident()]
    assert [s.name for s in main if s.parent == load.id] == (
        ["open"] + ["decode_wait", "ship"] * N_BATCHES + ["decode_wait", "narrow"])
    assert [s.attrs["frames"] for s in _named(spans, "ship")] == [3, 3, 3, 1]
    assert all(s.parent == load.id for s in _named(spans, "decode"))
    # the default wire ships delta6: four arrays a batch, then boxes and
    # reciprocal precisions; one range check narrows the window
    assert dt.kind == "q16" and {s.attrs["wire"] for s in _named(spans, "ship")} == {"delta6"}
    assert _syncs(counters) == {"materialize.copy": 6 * N_BATCHES, "materialize.range": 1}


def test_oneshot_pass_records_its_spans(case, monkeypatch):
    path, system = case
    monkeypatch.setenv("GROAN_ONESHOT_BYTES", str(10**9))
    runner = _pipe(system).runner()
    _, spans, counters = _traced(lambda: runner.run(path, batch_size=BATCH))
    _nested(spans)
    (p,) = _named(spans, "pass")
    assert p.attrs["route"] == "oneshot"
    names = [s.name for s in spans if s.parent == p.id]
    assert names == ["open", "open", "decode", "stage", "dispatch", "fetch"]
    assert _named(spans, "decode")[0].thread == threading.get_ident()
    assert _named(spans, "dispatch")[0].attrs == {"batch": 0, "frames": N_FRAMES}
    assert _syncs(counters) == {"oneshot.copy": 1, "rmsd.eigh": 1, "fetch.copy": 1}


@pytest.mark.parametrize("route", ["resident", "delta6", "q16", "oneshot"])
def test_results_are_the_same_with_tracing_on(case, monkeypatch, route):
    path, system = case
    monkeypatch.setenv("GROAN_ONESHOT_BYTES", str(10**9) if route == "oneshot" else "0")
    runner = _pipe(system).runner(wire="auto" if route in ("resident", "oneshot") else route)
    src = runner.load_device(path, batch_size=BATCH) if route == "resident" else path
    off = runner.run(src, batch_size=BATCH)
    on, spans, _ = _traced(lambda: runner.run(src, batch_size=BATCH))
    want = {"resident": "resident_fused", "oneshot": "oneshot"}.get(route, "streamed")
    assert _named(spans, "pass")[0].attrs["route"] == want
    if route in ("delta6", "q16"):
        assert {s.attrs["wire"] for s in _named(spans, "stage")} == {route}
    _same(on, off)


def test_nothing_is_recorded_with_tracing_off(case, monkeypatch):
    path, system = case
    monkeypatch.setenv("GROAN_ONESHOT_BYTES", "0")
    runner = _pipe(system).runner()
    with profiling.tracing() as rec:
        pass
    assert not profiling.TRACING and profiling.current() is None
    dt = runner.load_device(path, batch_size=BATCH)
    runner.run(dt, batch_size=BATCH)
    runner.run(path, batch_size=BATCH)
    assert rec.take() == ([], {})
    assert profiling.begin("x") is None and profiling.add("x", 0.0, 1.0) is None
    with profiling.span("x") as s:
        assert s is None


def test_recorder_nesting_and_an_exception():
    """A span an exception left open closes with its parent; blocks nest
    and the outer one records again after the inner."""
    with profiling.tracing() as outer:
        with pytest.raises(RuntimeError):
            with profiling.span("pass"):
                profiling.begin("dispatch", 1.0)
                raise RuntimeError("step failed")
        with profiling.tracing() as inner:
            profiling.add("decode", 2.0, 3.0, wire="q16")
        profiling.count("host_sync", "x", 2)
    p, d = outer.spans
    assert d.parent == p.id and d.t1 == p.t1 and p.t1 is not None
    assert outer.counters == {("host_sync", "x"): 2}
    (dec,) = inner.spans
    assert dec.parent is None and dec.seconds == 1.0 and dec.attrs == {"wire": "q16"}
    assert profiling.current() is None and not profiling.TRACING


def test_recorder_keeps_every_record_across_threads():
    """Many threads counting and adding spans at once lose nothing."""
    n_threads, n_each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.tracing() as rec:
            def work(k):
                for i in range(n_each):
                    profiling.count("host_sync", f"site{k % 3}")
                    profiling.add("decode", float(i), float(i + 1))

            threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans, counters = rec.take()
    assert len(spans) == n_threads * n_each
    assert len({s.id for s in spans}) == len(spans)
    assert sum(counters.values()) == n_threads * n_each
    assert counters[("host_sync", "site0")] == 6 * n_each
