"""The water box (`gen/water.py`), the hydrogen-bond oracle
(`reference/oracles/add_hbonds.py`), the chains' argument kind, and the
cell `hbond-water-streamed` with its metrics, found by name.  On the CPU
at small sizes; the full size as tables only."""

import copy
import json
import os
import time
import types

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.calibrate import control_numbers
from portbench.gen import water
from portbench.gen import xtc as xtcw
from portbench.reference.frames import Frames
from portbench.reference.judge import oracle as oracle_of

CELLS = ["hbond-water-streamed"]
METRICS = ["hbond_walk_ms_per_frame", "hbond_score_ms_per_frame",
           "idle_in_hbond_pct.streamed"]
QUERIES = {"acceptors": "name OW", "donors": "name OW", "hydrogens": "name HW1 HW2"}
CALL = {"call": "add_hbonds", "args": [{"hbond_chains": [QUERIES]}, [[0, 0]]],
        "kwargs": {"max_distance": 0.35, "min_angle": 120.0}}


def tiny_water(n_mol=900, frames=8, batch=4):
    """(cell, config, traffic) of `hbond-water-streamed` cut to `n_mol`
    waters at the configuration's density, `frames` frames."""
    cell, config, traffic = harness.resolve_cell("hbond-water-streamed")
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    edge = round((n_mol / 33.3) ** (1 / 3), 3)
    config.update(n_atoms=3 * n_mol, groups={"Water": [0, 3 * n_mol]}, frames=frames)
    config["box"]["lengths_nm"] = [edge] * 3
    traffic.update(frames=frames, batch=batch, warm_frames=batch)
    return cell, config, traffic


def _grid(config, seed, frames=None):
    syn = water.make(config, seed, "cpu", n_frames=frames)
    return syn, np.stack(list(syn.host_frames()))


def test_same_seed_same_bytes_and_prefix(tmp_path):
    _, config, _ = tiny_water()
    blobs = []
    for i, seed in enumerate((2**31 + 5, 2**31 + 5, 2**33 + 6)):
        syn = water.make(config, seed, "cpu")
        path = tmp_path / f"w{i}.xtc"
        xtcw.write_xtc(str(path), syn.host_frames(), syn.box9, syn.precision, syn.dt_ps,
                       threads=2)
        blobs.append(path.read_bytes())
    assert blobs[0] == blobs[1] and blobs[0] != blobs[2]
    _, long = _grid(config, 77, frames=8)
    _, short = _grid(config, 77, frames=5)
    np.testing.assert_array_equal(long[:5], short)
    syn = water.make(config, 77, "cpu", n_frames=8)
    np.testing.assert_array_equal(np.stack([q.numpy() for _, q in syn.grid_frames(3, 6)]),
                                  long[3:6])


def test_spc_geometry_on_the_grid_and_in_the_box():
    _, config, _ = tiny_water()
    syn, grid = _grid(config, 2**32 + 9)
    lq = int(round(config["box"]["lengths_nm"][0] * syn.precision))
    assert grid.min() >= 0 and grid.max() < lq
    x = grid.astype(np.float64) / syn.precision
    box = np.float64(lq) / syn.precision
    o, h1, h2 = x[:, 0::3], x[:, 1::3], x[:, 2::3]

    def vec(a, b):
        d = b - a
        return d - box * np.round(d / box)

    reach = np.sqrt(3) / syn.precision   # two atoms' rounding, worst case
    for h in (h1, h2):
        r = np.linalg.norm(vec(o, h), axis=-1)
        assert np.abs(r - water.OH_NM).max() <= reach
    a, b = vec(o, h1), vec(o, h2)
    cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)
    ang = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    assert np.abs(ang - water.HOH_DEG).max() < np.degrees(2 * reach / water.OH_NM)
    # a rigid move a frame: the O steps N(0, 0.02 nm) per axis
    step = np.abs(vec(o[0], o[1]))
    assert 0.01 < np.median(step) < 0.02


def test_full_size_tables():
    """256,000 OW, each with its HW1 and HW2 bonded; masses, charges."""
    cfg = harness.resolve_cell("hbond-water-streamed")[1]
    syn = water.make(cfg, 1, "cpu")
    assert (syn.n, syn.n_mol, syn.side, syn.n_frames) == (768000, 256000, 64, 24)
    lay = syn.layout()
    names = lay["atom_names"]
    assert (names == "OW").sum() == 256000 and (names == "HW1").sum() == 256000
    np.testing.assert_array_equal(np.nonzero(names == "OW")[0], lay["oxygens"])
    np.testing.assert_array_equal(names[lay["hydrogens"]],
                                  np.broadcast_to(["HW1", "HW2"], (256000, 2)))
    bonds = lay["bonds"]
    assert bonds.shape == (512000, 2) and (names[bonds[:, 0]] == "OW").all()
    assert np.array_equal(np.sort(bonds[:, 1]), np.sort(lay["hydrogens"].reshape(-1)))
    assert np.array_equal(np.bincount(bonds[:, 0], minlength=syn.n)[lay["oxygens"]],
                          np.full(256000, 2))
    assert abs(float(syn.charges().astype(np.float64).sum())) < 1e-3
    assert syn.masses()[:3].tolist() == pytest.approx(list(water.MASS))


def _brute(p, box, max_d=0.35, min_a=120.0):
    """Every donor x acceptor x hydrogen of one frame, numpy float64."""
    o = np.arange(0, p.shape[0], 3)

    def mi(d):
        return d - box * np.round(d / box)

    n = 0
    for k in (1, 2):
        da = mi(p[o][None, :, :] - p[o][:, None, :])       # [donor, acceptor, 3]
        r = np.linalg.norm(da, axis=-1)
        hd = mi(p[o] - p[o + k])[:, None, :]
        ha = mi(p[o][None, :, :] - p[o + k][:, None, :])
        cos = (hd * ha).sum(-1) / np.linalg.norm(hd, axis=-1) / np.linalg.norm(ha, axis=-1)
        with np.errstate(invalid="ignore"):   # the diagonal's H->D = H->A
            ang = np.degrees(np.arccos(cos))
        ok = (r <= max_d) & (ang >= min_a)
        np.fill_diagonal(ok, False)
        n += int(ok.sum())
    return n


def test_oracle_against_brute_force():
    _, config, traffic = tiny_water(n_mol=1000, frames=3)
    syn = water.make(config, 2**31 + 21, "cpu")
    p = torch.stack([syn.positions(q) for _, q in syn.grid_frames()])
    fr = Frames(syn, p, torch.float64, analysis=[CALL])
    mod = oracle_of("add_hbonds")
    lo, hi = mod.oracle(fr, CALL["args"], CALL["kwargs"], 1e-5)
    lo0, hi0 = mod.oracle(fr, CALL["args"], CALL["kwargs"], 0.0)
    box = float(fr.box[0, 0])
    want = [_brute(p[i].numpy(), box) for i in range(p.shape[0])]
    assert lo0.tolist() == hi0.tolist() == want
    assert all(a <= w <= b for a, w, b in zip(lo.tolist(), want, hi.tolist()))
    assert all(0 <= b - a <= 20 for a, b in zip(lo.tolist(), hi.tolist()))
    # a box of fewer than three cells an axis: every acceptor, the same count
    small = water.make(tiny_water(n_mol=20)[1], 3, "cpu")
    ps = torch.stack([small.positions(q) for _, q in small.grid_frames(0, 2)])
    frs = Frames(small, ps, torch.float64, analysis=[CALL])
    got = mod.oracle(frs, CALL["args"], CALL["kwargs"], 0.0)[0]
    assert got.tolist() == [_brute(ps[i].numpy(), float(frs.box[0, 0])) for i in range(2)]


def test_chains_argument_kind():
    from groan_rs_tpu_torch.system.hbonds import HBondChain

    ctx = types.SimpleNamespace(system=None, syn=None, state=None)
    got = harness.program_args(CALL["args"], ctx)
    assert got == [[HBondChain("name OW", "name OW", "name HW1 HW2")], [[0, 0]]]


def test_cells_configuration_traffic_and_metrics_found_by_name():
    assert "spc-water-768k" in harness.names("configs")
    assert "streamed-hbond-water-b12" in harness.names("traffic")
    assert "hbond_chains" in harness.names("args", ".py")
    from portbench.reference.judge import oracle_names

    assert "add_hbonds" in oracle_names() and oracle_of("add_hbonds").KIND == "bounds"
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name in CELLS:
        cell, config, traffic = harness.resolve_cell(name)
        assert cell["chips"] == 1 and traffic["entry"] == "streamed"
        e2e = [m["name"] for m in harness.cell_metrics(bench, name, False)]
        assert e2e == ["streamed_frames_per_s", "setup_s"]
        per = {m["name"] for m in harness.cell_metrics(bench, name, True)}
        assert {"decode_wait_ms_per_batch", "stage_ms_per_batch", "device_idle_pct.streamed",
                "first_batch_wait_ms.streamed", "decode_ms_per_batch.streamed",
                "idle_in_reader_pct.streamed"} <= per
        assert set(METRICS) <= per
    cell, config, traffic = harness.resolve_cell("hbond-water-streamed")
    assert (config["generator"], config["reduced"], traffic["frames"], traffic["batch"],
            traffic["topology"], traffic["warm_frames"]) == ("water", [], 24, 12, "full", 12)
    assert cell["limits"] == {"hbonds_0_0": 0.0}
    for name in METRICS:
        mod = harness.metric_reader(name)
        assert mod.NAME == name and mod.MOVES == "streamed_frames_per_s"


def _trace(host, split, window=2.0):
    return {"host_ms_per_pass": host, "split": split, "window_s": window}


def test_hbond_readers():
    host = {"pass": 900.0, "hbond": 800.0, "hbond/walk": 480.0, "hbond/score": 96.0}
    split = {"hbond": 0.2, "hbond/walk": 1.0, "hbond/score": 0.1, "decode_wait": 0.3}
    ctx = types.SimpleNamespace(traffic={"entry": "streamed"}, frames=24,
                                _program_trace=_trace(host, split))
    read = {n: harness.metric_reader(n).read(ctx) for n in METRICS}
    assert read == pytest.approx({"hbond_walk_ms_per_frame": 20.0,
                                  "hbond_score_ms_per_frame": 4.0,
                                  "idle_in_hbond_pct.streamed": 65.0})
    # a program without the hbond spans (a parent commit), a resident
    # cell and a run without a program trace read nothing
    for tr, entry in ((_trace({"pass": 1.0}, {"pass": 0.1}), "streamed"),
                      (_trace(host, split), "resident"), (None, "streamed")):
        ctx = types.SimpleNamespace(traffic={"entry": entry}, frames=24, _program_trace=tr)
        assert all(harness.metric_reader(n).read(ctx) is None for n in METRICS)


def test_water_control_is_not_correct():
    cell, config, traffic = tiny_water()
    for seed in (2**31 + 1, 2**32 + 7):
        numbers = control_numbers(config, traffic, seed, "cpu")
        assert set(numbers) == {"hbonds_0_0"} and numbers["hbonds_0_0"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_a_broken_one_is_not(name, monkeypatch):
    from groan_rs_tpu_torch.models.pipeline import PipelineRunner

    from portbench.reference.judge import output_name

    cell, config, traffic = tiny_water()
    res = harness.run_cell(cell, config, traffic, 2**31 + 3, 0.2, False, "cpu",
                           time.perf_counter(), harness.benchmark(harness.ROOT))
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"streamed_frames_per_s", "setup_s"}
    outs = [output_name(c) for c in traffic["analysis"]]
    run = PipelineRunner.run

    def broken(self, *a, **kw):
        # one answer altered where it is produced: a count by 1% (a count
        # within the oracle's edge band may be either), a number by 1e-3
        got = run(self, *a, **kw)
        for k in outs:
            v = np.array(got[k], copy=True)
            v[1] = v[1] + max(1, v[1] // 100) if v.dtype.kind in "iu" else (
                v[1] * (1 + 1e-3) + 1e-3)
            got[k] = v
        return got

    monkeypatch.setattr(PipelineRunner, "run", broken)
    res = harness.run_cell(cell, config, traffic, 2**31 + 3, 0.2, False, "cpu",
                           time.perf_counter())
    assert res["correct"] is False and res["failed"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_new_cell_on_the_card(cell, cuda_card):
    """A short run of each new cell on the card: the result line, `correct`."""
    import subprocess
    import sys

    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                        str(2**31 + 17), "--seconds", "2", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0


@pytest.mark.card
def test_full_size_resolves_to_cells_on_q16(cuda_card):
    """At 768,000 atoms on the card, `add_hbonds(method="auto")` takes the
    cell method and the runner the q16 wire, every atom shipped."""
    from groan_rs_tpu_torch import convert

    cell, config, traffic = harness.resolve_cell("hbond-water-streamed")
    syn = water.make(config, 2**31 + 5, cuda_card, n_frames=1)
    ctx = types.SimpleNamespace(syn=syn, state=syn.state(traffic["topology"]))
    ctx.system = convert.system_from_state(ctx.state, device=cuda_card)
    pipe = harness.build_analysis(traffic, ctx, cuda_card)
    runner = pipe.runner()
    assert [nm for nm, _ in pipe._hbond_specs] == ["hbonds"] and not pipe._multi_factories
    assert runner.wire == "q16" and runner.sel is None
