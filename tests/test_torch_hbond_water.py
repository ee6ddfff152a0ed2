"""Hydrogen bonds across a box of rigid SPC waters (the benchmark's water
generator, `portbench/gen/water.py`) by the port's cell method.

At a 3 nm box (900 waters at 33.3 nm^-3, 8 frames, two seeds, batches of 1
and 4), on the CPU: `add_hbonds(method="auto")` resolves to the cell
method (the dense limit lowered below the box's pairs; at the published
768,000 atoms the rule itself picks cells), the pass's counts lie in the
float64 oracle's bounds (`portbench/reference/oracles/add_hbonds.py`) and
equal `System.hbonds_analyze` exactly, and a traced pass records the
`hbond` spans under `pass` with the candidate counter equal to the
analysis's own `batch_stats`, batch by batch and on the one-shot route."""

import copy

import numpy as np
import pytest
import torch

from groan_rs_tpu_torch import convert
from groan_rs_tpu_torch.io import native
from groan_rs_tpu_torch.models import TrajectoryAnalysis
from groan_rs_tpu_torch.models import pipeline
from groan_rs_tpu_torch.system.hbonds import HBondChain
from groan_rs_tpu_torch.utils import profiling
from portbench import harness
from portbench.reference.frames import Frames
from portbench.reference.judge import oracle as oracle_of

N_MOL, BOX, N_FRAMES = 900, 3.0, 8
SEEDS = (2**31 + 11, 2**40 + 5)
QUERIES = {"acceptors": "name OW", "donors": "name OW", "hydrogens": "name HW1 HW2"}
CASES = [(s, b) for s in SEEDS for b in (1, 4)]


def _config(n_mol=N_MOL, box=BOX, frames=N_FRAMES):
    _, config, _ = harness.resolve_cell("hbond-water-streamed")
    config = copy.deepcopy(config)
    config.update(n_atoms=3 * n_mol, groups={"Water": [0, 3 * n_mol]}, frames=frames)
    config["box"]["lengths_nm"] = [box] * 3
    return config


def _chains():
    return [HBondChain(**QUERIES)]


def _analysis(system):
    return TrajectoryAnalysis(system, device="cpu").add_hbonds(
        _chains(), [(0, 0)], max_distance=0.35, min_angle=120.0)


_runs = {}


def _run(seed, batch, tmp_path_factory):
    """(generator, System, xtc, traced pass's output, runner, analysis,
    spans, counters) of one seed and batch size, made once."""
    key = (seed, batch)
    if key in _runs:
        return _runs[key]
    syn = harness.make_system(_config(), seed, "cpu")
    xtc = str(tmp_path_factory.mktemp("water") / "water.xtc")
    for f, q in enumerate(syn.host_frames()):
        native.xtc_write_frame(xtc, syn.n, f * 1000, f * syn.dt_ps, syn.box9,
                               q.astype(np.float32) / np.float32(syn.precision),
                               syn.precision)
    system = convert.system_from_state(syn.state("full"), device="cpu")
    mp = pytest.MonkeyPatch()
    try:
        # at 900 waters the dense counter's limit (10^8 pairs a leg) would
        # take the pass; lowered, "auto" resolves to cells as at full size
        mp.setattr(pipeline, "_DENSE_MAX_PAIRS", 10**5)
        mp.setenv("GROAN_ONESHOT_BYTES", "0")   # stream, batch by batch
        pipe = _analysis(system)
        runner = pipe.runner()
        with profiling.tracing() as rec:
            out = runner.run(xtc, batch_size=batch)
    finally:
        mp.undo()
    spans, counters = rec.take()
    _runs[key] = (syn, system, xtc, out, runner, pipe, spans, counters)
    return _runs[key]


@pytest.mark.parametrize("seed,batch", CASES)
def test_auto_resolves_to_cells(seed, batch, tmp_path_factory):
    _, _, _, out, runner, pipe, _, _ = _run(seed, batch, tmp_path_factory)
    assert [nm for nm, _ in pipe._hbond_specs] == ["hbonds"]
    assert not pipe._multi_factories and not pipe._dense_strict
    assert runner.wire == "q16" and runner.sel is None and runner.last_route == "streamed"
    assert out["hbonds_0_0"].shape == (N_FRAMES,) and out["hbonds_0_0"].dtype == np.int64
    assert len(runner.hbond_specs[0][1].batch_stats) == -(-N_FRAMES // batch)


def test_auto_resolves_to_cells_at_full_size():
    """At 768,000 atoms (256,000 donors and acceptors a leg) the rule
    itself picks the cell method; tables only, frame 0 for the state."""
    syn = harness.make_system(harness.resolve_cell("hbond-water-streamed")[1], 2**31 + 1,
                              "cpu", n_frames=1)
    assert syn.n == 768000 and syn.side == 64
    system = convert.system_from_state(syn.state("full"), device="cpu")
    pipe = _analysis(system)
    assert [nm for nm, _ in pipe._hbond_specs] == ["hbonds"] and not pipe._multi_factories
    legs = pipe._hbond_specs[0][1]._tables().legs
    assert [(acc.acceptors.shape[0], don.donors.shape[0]) for _, acc, don, _, _ in legs] == [
        (256000, 256000)]
    assert pipe._hbond_specs[0][1]._tables().rank_dtype == np.int32


@pytest.mark.parametrize("seed,batch", CASES)
def test_counts_within_the_oracle_bounds(seed, batch, tmp_path_factory):
    syn, _, _, out, *_ = _run(seed, batch, tmp_path_factory)
    call = {"call": "add_hbonds", "args": [{"hbond_chains": [QUERIES]}, [[0, 0]]],
            "kwargs": {"max_distance": 0.35, "min_angle": 120.0}}
    p = torch.stack([syn.positions(q) for _, q in syn.grid_frames()])
    lo, hi = oracle_of("add_hbonds").oracle(Frames(syn, p, torch.float64, analysis=[call]),
                                            call["args"], call["kwargs"], 1e-5)
    got = torch.as_tensor(out["hbonds_0_0"])
    assert bool(((got >= lo) & (got <= hi)).all()), (got, lo, hi)
    assert int(got.min()) > N_MOL   # more than a bond a water, every frame


@pytest.mark.parametrize("seed,batch", CASES)
def test_counts_equal_the_host_path(seed, batch, tmp_path_factory):
    _, system, xtc, out, *_ = _run(seed, batch, tmp_path_factory)
    want = [len(hmap[(0, 0)]) for _, hmap in system.hbonds_analyze(
        xtc, _chains(), [(0, 0)], max_distance=0.35, min_angle=120.0)]
    np.testing.assert_array_equal(out["hbonds_0_0"], want)


@pytest.mark.parametrize("seed,batch", CASES)
def test_traced_pass_records_the_hbond_spans(seed, batch, tmp_path_factory):
    _, _, _, _, runner, _, spans, counters = _run(seed, batch, tmp_path_factory)
    by_id = {s.id: s for s in spans}
    (p,) = [s for s in spans if s.name == "pass"]
    hb = [s for s in spans if s.name == "hbond"]
    n_batches = -(-N_FRAMES // batch)
    assert len(hb) == n_batches and all(s.parent == p.id for s in hb)
    assert [s.attrs for s in hb] == [{"batch": i, "frames": batch} for i in range(n_batches)]
    for name in ("hbond/walk", "hbond/ship", "hbond/score", "hbond/rescore"):
        got = [s for s in spans if s.name == name]
        assert len(got) == n_batches, name
        assert all(by_id[s.parent].name == "hbond" and s.pass_id == p.id
                   and by_id[s.parent].t0 <= s.t0 <= s.t1 <= by_id[s.parent].t1 for s in got)
    stats = runner.hbond_specs[0][1].batch_stats
    assert counters[("hbond_candidates", "analyze_batch")] == sum(
        int(s["candidates"].sum()) for s in stats)
    assert counters.get(("hbond_guarded", "analyze_batch"), 0) == sum(
        int(s["guarded"].sum()) for s in stats)
    assert counters[("host_sync", "hbond.nonzero")] == n_batches
    assert counters[("host_sync", "hbond.copy")] == 5 * n_batches


def test_oneshot_route_records_one_hbond_span(tmp_path_factory):
    """A pass small enough for the one-shot route hands its one batch to
    the cell method: the same counts, one `hbond` span of every frame."""
    seed, batch = CASES[0]
    _, system, xtc, out, *_ = _run(seed, batch, tmp_path_factory)
    runner = TrajectoryAnalysis(system, device="cpu").add_hbonds(
        _chains(), [(0, 0)], method="cells").runner()
    with profiling.tracing() as rec:
        again = runner.run(xtc, batch_size=batch)
    spans, _ = rec.take()
    assert runner.last_route == "oneshot"
    np.testing.assert_array_equal(again["hbonds_0_0"], out["hbonds_0_0"])
    (p,) = [s for s in spans if s.name == "pass"]
    (hb,) = [s for s in spans if s.name == "hbond"]
    assert hb.parent == p.id and hb.attrs == {"batch": 0, "frames": N_FRAMES}
