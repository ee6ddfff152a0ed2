"""Hydrogen bonds in the PyTorch port against the JAX package.

Input: the seeded 3,000-atom synthetic system (`testing.build_trajectory`
in a 3 nm box, so that its 566 whole waters and the cut-short last one
sit at liquid water's density, 21 O per nm^3) with the full topology
(`synthetic_state(..., topology="full")`: explicit O-H and lipid bonds),
one state through both packages.  Chains: water (OW / OW / HW1 HW2) and
the lipids (C / C / H).

Tolerances: candidate ranks, bond indices and counts exact; guard counts
exact but for triples within 1e-4 degrees of the band's edge, where
XLA's acos and torch's round apart (`_band_edge_triples`); `analyze` bit
for bit; device bond lists within 1e-6 nm in
distance and 2e-6 in cos(angle) of the host path (the JAX test's,
`tests/test_hbonds_device.py:46-71`).  Also the 3-atom threshold case of
`tests/test_hbonds_strict_dense.py`, a frame with more than 128 guarded
triples (JAX's compact-list capacity), the dense counter's one call per
step, the q16 dequantization on host and device bit for bit, the
pipeline (cells, dense, auto; streamed, resident, run_many) and every
HBondError code."""

import math

import numpy as np
import pytest
import torch

from groan_rs_tpu.models import TrajectoryAnalysis as JTA
from groan_rs_tpu.models import run_many as j_run_many
from groan_rs_tpu.system import hbonds as jh

from _torch_parity import jax_system, state_from_jax_system
from groan_rs_tpu_torch import convert, testing
from groan_rs_tpu_torch.core.simbox import SimBox
from groan_rs_tpu_torch.core.topology import Topology
from groan_rs_tpu_torch.errors import HBondError, ParallelError
from groan_rs_tpu_torch.io import native
from groan_rs_tpu_torch.models import TrajectoryAnalysis as TTA
from groan_rs_tpu_torch.models import run_many
from groan_rs_tpu_torch.parallel import FrameEngine
from groan_rs_tpu_torch.system import System
from groan_rs_tpu_torch.system import hbonds as th

N_ATOMS, N_FRAMES, BOX = 3000, 10, 3.0
GROUPS = ("Protein", "Membrane", "Peptide", "Water")
WATER = ("name OW", "name OW", "name HW1 HW2")
LIPID = ("name C", "name C", "name H")


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    xtc = str(tmp_path_factory.mktemp("hb") / "synthetic.xtc")
    testing.build_trajectory(xtc, N_ATOMS, N_FRAMES, box_len=BOX)
    offs, _, _, nat = native.xtc_scan(xtc)
    coords, b9, *_ = native.xtc_read_frames(xtc, offs, nat)
    boxes = b9[:, [0, 4, 8]].copy()
    # the tests write frames into both Systems: each holds its own copy
    state = testing.synthetic_state(coords[0].copy(), boxes[0], topology="full")
    jsys = jax_system(state)
    tstate = state_from_jax_system(jsys, GROUPS)
    tstate["positions"] = tstate["positions"].copy()
    tsys = convert.system_from_state(tstate)
    return xtc, coords, boxes, jsys, tsys


def _chains(mod, *specs):
    return [mod.HBondChain(*s) for s in specs]


def _analyses(jsys, tsys, specs, pairs, max_distance=0.35, min_angle=120.0):
    ja = jh.HBondAnalysis(jsys, _chains(jh, *specs), pairs, max_distance, min_angle)
    ta = th.HBondAnalysis(tsys, _chains(th, *specs), pairs, max_distance, min_angle,
                          device="cpu")
    return ja, ta


def _fields(bonds):
    return [(b.donor, b.hydrogen, b.acceptor, b.distance, b.angle) for b in bonds]


def _close(got, want):
    """Device bond lists against host ones: indices exact, in order."""
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert (x.donor, x.hydrogen, x.acceptor) == (y.donor, y.hydrogen, y.acceptor)
        assert abs(x.distance - y.distance) < 1e-6
        assert abs(math.cos(math.radians(x.angle)) - math.cos(math.radians(y.angle))) < 2e-6


@pytest.mark.parametrize("legs", ["water", "water-lipid", "lipid-water"])
@pytest.mark.parametrize("max_distance", [0.35, 0.5, 1.6])
def test_candidate_walk_matches(systems, legs, max_distance):
    """The C++ walk, its numpy twin and the JAX walk give the same ranks in
    the same order (1.6 nm: one cell per axis, offsets deduplicated)."""
    _, coords, boxes, jsys, tsys = systems
    specs = {"water": (WATER,), "water-lipid": (WATER, LIPID),
             "lipid-water": (LIPID, WATER)}[legs]
    pairs = [(0, 0)] if len(specs) == 1 else [(0, 1)]
    ja, ta = _analyses(jsys, tsys, specs, pairs, max_distance)
    acc, don = ta.chains[0], ta.chains[-1]
    for f in range(3):
        got = th._candidate_pairs(coords[f], boxes[f], acc, don, max_distance)
        twin = th._candidate_pairs_np(coords[f], boxes[f], acc, don, max_distance)
        want = jh._candidate_pairs(coords[f], boxes[f], ja.chains[0], ja.chains[-1],
                                   max_distance)
        assert got[0].shape[0] > 0
        for g, t, w in zip(got, twin, want):
            assert np.array_equal(g, w) and np.array_equal(t, w)


@pytest.mark.parametrize("pairs", [[(0, 0)], [(0, 0), (0, 1)]])
def test_analyze_is_bit_identical(systems, pairs):
    """The host path, one chain and two (water, lipid; legs in the
    reference's order), on every frame."""
    _, coords, boxes, jsys, tsys = systems
    specs = (WATER,) if len(pairs) == 1 else (WATER, LIPID)
    ja, ta = _analyses(jsys, tsys, specs, pairs)
    total = 0
    for f in range(N_FRAMES):
        jsys.positions[:] = tsys.positions[:] = coords[f]
        want, got = ja.analyze(jsys), ta.analyze(tsys)
        assert list(got) == list(want)
        for k in want:
            assert _fields(got[k]) == _fields(want[k])
            total += len(want[k])
    jsys.positions[:] = tsys.positions[:] = coords[0]
    assert total > 100


@pytest.mark.parametrize("pairs", [[(0, 0)], [(0, 0), (0, 1)]])
def test_analyze_batch_matches(systems, pairs):
    """Bond lists and counts_only of the device path (CPU tensors) against
    the JAX batch path and the host path; q16 ints dequantized on the
    device give the f32 path's counts."""
    xtc, coords, boxes, jsys, tsys = systems
    specs = (WATER,) if len(pairs) == 1 else (WATER, LIPID)
    ja, ta = _analyses(jsys, tsys, specs, pairs)
    got = ta.analyze_batch(coords, boxes)
    want = ja.analyze_batch(coords, boxes)
    for f in range(N_FRAMES):
        tsys.positions[:] = coords[f]
        host = ta.analyze(tsys)
        assert list(got[f]) == list(want[f]) == list(host)
        for k in host:
            _close(got[f][k], host[k])
            _close(want[f][k], host[k])
    tsys.positions[:] = coords[0]
    counts = ta.analyze_batch(coords, boxes, counts_only=True)
    jcounts = ja.analyze_batch(coords, boxes, counts_only=True)
    offs, *_ = native.xtc_scan(xtc)
    q, _, _, _, prec = native.xtc_read_frames_q16(xtc, offs, N_ATOMS)
    inv = np.float32(1.0) / prec
    qcounts = ta.analyze_batch(coords, boxes, counts_only=True, q_positions=q,
                               inv_prec=inv)
    for p in ta.pairs:
        assert np.array_equal(counts[p], jcounts[p])
        assert np.array_equal(qcounts[p], counts[p])
        assert counts[p].dtype == np.int64
        assert np.array_equal(counts[p], [len(m[p]) for m in got])
    assert ta.batch_stats[-1]["candidates"].sum() > 0


def _band_edge_triples(ta, coords, boxes, width=1e-4):
    """Per frame, the dense triples whose float64 D-H-A angle lies within
    `width` degrees of the guard band's edge (|angle - min_angle| = 2e-3 +
    the arccos term): there, one acos ulp (~1e-5 degrees near 120) decides
    whether the triple is guarded, and XLA's acos (an atan2 polynomial)
    and torch's round differently."""
    tables = ta._tables()
    out = np.zeros(coords.shape[0], np.int64)
    for _, acc_g, don_g, don_off, _ in tables.legs:
        nd = don_g.donors.shape[0]
        h_tab = tables.h_tab[don_off:don_off + nd]
        h_ok = np.arange(h_tab.shape[1])[None, :] < tables.h_cnt[don_off:don_off + nd, None]
        for f in range(coords.shape[0]):
            p, L = coords[f].astype(np.float64), boxes[f].astype(np.float64)
            hp = p[h_tab]                                          # [D, H, 3]

            def vec(a, b):
                d = b - a
                return d - L * np.floor(d / L + 0.5)

            hd = vec(hp, p[don_g.donors][:, None, :])              # [D, H, 3]
            ha = vec(hp[:, :, None, :], p[acc_g.acceptors][None, None])  # [D, H, A, 3]
            cos = (hd[:, :, None, :] * ha).sum(-1) / (
                np.linalg.norm(hd, axis=-1)[..., None] * np.linalg.norm(ha, axis=-1))
            cos = np.clip(cos, -1.0, 1.0)
            band = 2e-3 + 57.29578e-6 / np.sqrt(np.maximum(1.0 - cos * cos, 1e-12))
            edge = np.abs(np.abs(np.degrees(np.arccos(cos)) - ta.min_angle) - band) < width
            ok = h_ok[..., None] & (don_g.donors[:, None, None]
                                    != acc_g.acceptors[None, None, :])
            out[f] += int((edge & ok).sum())
    return out


@pytest.mark.parametrize("tile", [None, 7])
def test_dense_counter_matches_jax(systems, tile):
    """Counts with and without the guard equal JAX's, and the host path's
    with the guard's frames re-scored.  Guard counts equal JAX's up to the
    triples at the band's edge, where the two acos implementations round
    differently (`_band_edge_triples`); the donor tile changes nothing."""
    import jax.numpy as jnp

    _, coords, boxes, jsys, tsys = systems
    ja, ta = _analyses(jsys, tsys, (WATER, LIPID), [(0, 0), (0, 1)])
    pos, box = torch.from_numpy(coords), torch.from_numpy(boxes)
    jc, jg = jh.make_dense_counter(ja, with_guard=True)(jnp.asarray(coords),
                                                         jnp.asarray(boxes))
    tc, tg = th.make_dense_counter(ta, tile=tile, with_guard=True)(pos, box)
    plain = th.make_dense_counter(ta, tile=tile)(pos, box)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(plain.numpy(), tc.numpy())
    gap = np.abs(tg.numpy() - np.asarray(jg, np.int64))
    edge = _band_edge_triples(ta, coords, boxes)
    assert (gap <= edge).all() and (gap == 0).sum() >= N_FRAMES - 2, (gap, edge)
    assert tg.numpy().min() > 0  # ~3e-5 of the triples sit in the band
    if tile is not None:
        assert np.array_equal(
            tg.numpy(), th.make_dense_counter(ta, with_guard=True)(pos, box)[1].numpy())
    counts = ta.analyze_batch(coords, boxes, counts_only=True)
    assert np.array_equal(tc.numpy(), np.stack([counts[p] for p in ta.pairs], 1))


def _threshold_case(tmp_path):
    """A 3-atom D/H/A system and a 3-frame XTC whose middle frame puts the
    angle exactly on the float32 threshold (`tests/test_hbonds_strict_dense.py:33-72`)."""
    box = np.array([3.0, 3.0, 3.0], np.float32)
    topo = Topology.from_columns(np.array([1, 1, 1]), ["MOL"] * 3, ["OD", "H1", "OA"],
                                 np.array([1, 2, 3]))
    topo.set_bonds_from_pairs(np.array([[0, 1]]))
    pos = np.array([[1.00, 1.00, 1.00], [1.10, 1.02, 1.00], [1.31, 1.17, 1.00]],
                   np.float32)
    xtc = str(tmp_path / "thr.xtc")
    box9 = np.diag(box).astype(np.float32).reshape(9)
    for f in range(3):
        p = pos.copy()
        p[2, 2] += 0.004 * (f - 1)  # frames 0 and 2 off the threshold
        native.xtc_write_frame(xtc, 3, f, float(f), box9, p, 1000.0)
    s = System("thr", topo, SimBox.from_lengths(*map(float, box)), positions=pos)
    s.set_precision(1000)
    chains = [th.HBondChain("name OA", "name OD", "name H1")]
    off, _, _, n = native.xtc_scan(xtc)
    c, *_ = native.xtc_read_frames(xtc, off, n)
    s.positions[:] = c[1]
    (hb,) = s.hbonds_analyze_frame(chains, [(0, 0)], max_distance=0.5,
                                   min_angle=0.0)[(0, 0)]
    s.positions[:] = pos
    return s, chains, xtc, float(np.float32(hb.angle)), c, box


def test_threshold_guard_and_strict_dense(tmp_path):
    s, chains, xtc, thr, frames, box = _threshold_case(tmp_path)
    ana = th.HBondAnalysis(s, chains, [(0, 0)], 0.5, thr, device="cpu")
    _, guarded = th.make_dense_counter(ana, with_guard=True)(
        torch.from_numpy(frames[1:2]), torch.from_numpy(box[None]))
    assert int(guarded[0]) >= 1  # the angle sits ON the threshold

    def run(method, **kw):
        pipe = TTA(s, device="cpu").add_hbonds(chains, [(0, 0)], 0.5, thr, name="hb",
                                               method=method, **kw)
        runner = pipe.runner(ship="all")
        return runner, runner.run(xtc, batch_size=2)

    runner, dense = run("dense")
    _, cells = run("cells")
    assert np.array_equal(dense["hb_0_0"], cells["hb_0_0"])
    assert int(dense["hb_0_0"][1]) == 1  # angle == threshold is kept
    assert not any(k.startswith("__guard__") for k in dense)
    assert runner.last_guards["hb"][1] >= 1
    dt = runner.load_device(xtc, batch_size=2)
    assert np.array_equal(runner.run(dt, batch_size=2)["hb_0_0"], cells["hb_0_0"])


def _lattice_case(n_side=(6, 6, 4)):
    """Copies of one D-H-A motif 1 nm apart, each within float rounding of
    the same angle: one frame with more than 128 guarded triples."""
    motif = np.array([[0.10, 0.10, 0.10], [0.20, 0.12, 0.10], [0.41, 0.27, 0.10]],
                     np.float32)
    grid = np.stack(np.meshgrid(*[np.arange(k) for k in n_side], indexing="ij"),
                    -1).reshape(-1, 3).astype(np.float32)
    pos = (grid[:, None, :] + motif[None]).reshape(-1, 3)
    # acceptors a few ulps apart in x: angles ~4e-4 degrees apart, inside
    # the 2e-3 degree band
    pos[2::3, 0] += ((np.arange(grid.shape[0]) % 9 - 4) * 5e-7).astype(np.float32)
    n = pos.shape[0]
    box = np.asarray(n_side, np.float32)
    names = np.tile(["OD", "H1", "OA"], n // 3)
    systems = []
    for mod_topo, mod_sys, mod_box in (
            (__import__("groan_rs_tpu.core.topology", fromlist=["Topology"]).Topology,
             __import__("groan_rs_tpu.system", fromlist=["System"]).System,
             __import__("groan_rs_tpu.core.simbox", fromlist=["SimBox"]).SimBox),
            (Topology, System, SimBox)):
        topo = mod_topo.from_columns(np.arange(n) // 3 + 1, ["MOL"] * n, names,
                                     np.arange(1, n + 1))
        topo.set_bonds_from_pairs(np.stack([np.arange(0, n, 3), np.arange(1, n, 3)], 1))
        systems.append(mod_sys("lattice", topo, simbox=mod_box.from_lengths(*map(float, box)),
                               positions=pos.copy()))
    return systems, pos, box


def test_many_guarded_triples_match_jax_whole_frame_path():
    (jsys, tsys), pos, box = _lattice_case()
    specs = (("name OA", "name OD", "name H1"),)
    probe = th.HBondAnalysis(tsys, _chains(th, *specs), [(0, 0)], 0.5, 0.0)
    angles = sorted(b.angle for b in probe.analyze(tsys)[(0, 0)])
    thr = angles[len(angles) // 2]  # the copies' angles differ by rounding
    ja, ta = _analyses(jsys, tsys, specs, [(0, 0)], 0.5, thr)
    host = len(ta.analyze(tsys)[(0, 0)])
    got = ta.analyze_batch(pos[None], box[None], counts_only=True)[(0, 0)]
    want = jh.HBondAnalysis.analyze_batch(ja, pos[None], box[None], counts_only=True)
    assert ta.batch_stats[-1]["guarded"][0] > jh._GUARD_K  # JAX: whole-frame pull
    assert int(got[0]) == int(want[(0, 0)][0]) == host
    assert 0 < host < pos.shape[0] // 3  # both sides of the threshold


def test_dense_counter_runs_once_per_step(systems):
    xtc, _, _, _, tsys = systems
    pipe = TTA(tsys, device="cpu").add_hbonds(
        _chains(th, WATER, LIPID), [(0, 0), (0, 1)], name="hb", method="dense")
    runner = pipe.runner()
    out = runner.run(xtc, batch_size=4)
    assert pipe.dense_counters["hb"].calls == 3  # 10 frames in batches of 4
    assert set(out) == {"hb_0_0", "hb_0_1", "times", "steps"}


def test_q16_dequantization_host_equals_device(systems):
    """The pipeline's host copy (`q.astype(f32) * inv`) and the engine's
    device dequantization give the same float32 bits; the decoder's f32
    frames too."""
    xtc, coords, *_ = systems
    offs, *_ = native.xtc_scan(xtc)
    q, _, _, _, prec = native.xtc_read_frames_q16(xtc, offs, N_ATOMS)
    inv = np.float32(1.0) / prec
    host = q.astype(np.float32) * inv[:, None, None]
    seen = {}

    def step(pos, boxes, mask):
        seen["pos"] = pos.clone()
        return {"n": mask.sum(0, keepdim=True)}

    eng = FrameEngine(step, "cpu")
    eng._step("q16", torch.from_numpy(q), torch.ones(N_FRAMES, 3),
              torch.ones(N_FRAMES, dtype=torch.bool), torch.from_numpy(inv))
    dev = seen["pos"].numpy()
    assert np.array_equal(dev.view(np.int32), host.view(np.int32))
    assert np.array_equal(host.view(np.int32), coords.view(np.int32))


def _jax_pass(jsys, xtc, method, strict, where):
    pipe = JTA(jsys).add_hbonds(_chains(jh, WATER, LIPID), [(0, 0), (0, 1)], name="hb",
                                method=method, strict=strict)
    if where == "streamed":
        return pipe.runner().run(xtc, batch_size=4)
    runner = pipe.runner(ship="all")
    dt = runner.load_device(xtc, batch_size=4)
    if where == "resident":
        return runner.run(dt, batch_size=4)
    return j_run_many([runner], dt, batch_size=4)[0]


def _port_pass(tsys, xtc, method, strict, where):
    pipe = (TTA(tsys, device="cpu")
            .add_hbonds(_chains(th, WATER, LIPID), [(0, 0), (0, 1)], name="hb",
                        method=method, strict=strict)
            .add_com("Protein"))
    if where == "streamed":
        return pipe.runner().run(xtc, batch_size=4)
    runner = pipe.runner(ship="all")
    dt = runner.load_device(xtc, batch_size=4)
    if where == "resident":
        return runner.run(dt, batch_size=4)
    return run_many([runner], dt, batch_size=4)[0]


@pytest.mark.parametrize("where", ["streamed", "resident", "run_many"])
@pytest.mark.parametrize("method,strict", [("cells", True), ("dense", True),
                                           ("dense", False), ("auto", True)])
def test_pipeline_matches_jax(systems, method, strict, where):
    """Counts per pair and frame equal the JAX pipeline's; the cell method
    refuses a resident window in both packages.  ("auto" picks dense
    here: 321k pairs per leg.)"""
    xtc, _, _, jsys, tsys = systems
    if method == "cells" and where != "streamed":
        with pytest.raises(ParallelError, match="filename"):
            _port_pass(tsys, xtc, method, strict, where)
        with pytest.raises(Exception, match="streamed pass"):
            _jax_pass(jsys, xtc, method, strict, where)
        return
    want = _jax_pass(jsys, xtc, method, strict, where)
    got = _port_pass(tsys, xtc, method, strict, where)
    for k in ("hb_0_0", "hb_0_1"):
        assert got[k].dtype == np.int64 and got[k].shape == (N_FRAMES,)
        assert np.array_equal(got[k], want[k]), k
    assert not any(k.startswith("__guard__") for k in got)
    assert got["com_Protein"].shape == (N_FRAMES, 3)
    # exact counts: every method equals the host path on every frame
    ta = th.HBondAnalysis(tsys, _chains(th, WATER, LIPID), [(0, 0), (0, 1)], 0.35, 120.0)
    _, coords, *_ = systems
    host = []
    for f in range(N_FRAMES):
        tsys.positions[:] = coords[f]
        host.append([len(v) for v in ta.analyze(tsys).values()])
    tsys.positions[:] = coords[0]
    if strict:
        assert np.array_equal(np.stack([got["hb_0_0"], got["hb_0_1"]], 1), host)


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 (the class is compared)
        return type(e).__name__, getattr(e, "code", None)
    return None


@pytest.mark.parametrize("case", [
    "EmptyChain", "NonexistentChain", "PairSpecifiedMultipleTimes", "UnusedChain",
    "SelectError", "InvalidSelection", "UncoveredGroup", "InvalidMethod",
    "InvalidWire"])
def test_hbond_error_codes(systems, case):
    """The port raises HBondError with the JAX package's code (the JAX
    package raises GroupError for an unknown method and the delta wire,
    HBondError for the rest).  A runner whose `group` leaves out chain
    atoms raises GroupError InvalidSelection in both, before any remap."""
    xtc, _, _, jsys, tsys = systems

    def call(TA, mod, system):
        w = _chains(mod, WATER)
        two = _chains(mod, WATER, LIPID)
        if case == "EmptyChain":
            return mod.HBondAnalysis(system, _chains(mod, ("name X", "name X", "name H")),
                                     [(0, 0)], 0.35, 120.0)
        if case == "NonexistentChain":
            return mod.HBondAnalysis(system, w, [(0, 1)], 0.35, 120.0)
        if case == "PairSpecifiedMultipleTimes":
            return mod.HBondAnalysis(system, two, [(0, 1), (1, 0)], 0.35, 120.0)
        if case == "UnusedChain":
            return mod.HBondAnalysis(system, two, [(0, 0)], 0.35, 120.0)
        if case == "SelectError":
            return mod.HBondAnalysis(system, _chains(mod, ("name (", "name OW", "name H")),
                                     [(0, 0)], 0.35, 120.0)
        if case == "InvalidSelection":
            lut = np.full(N_ATOMS, -1, np.int64)
            lut[:1300] = np.arange(1300)  # protein and membrane only
            return mod.remap_analysis(mod.HBondAnalysis(system, w, [(0, 0)], 0.35, 120.0),
                                      lut)
        if case == "UncoveredGroup":
            return TA().add_hbonds(w, [(0, 0)], method="cells").runner(group="Protein")
        if case == "InvalidMethod":
            return TA().add_hbonds(w, [(0, 0)], method="tiles")
        return TA().add_hbonds(w, [(0, 0)], method="cells").runner(wire="delta")

    want = _raised(lambda: call(lambda: JTA(jsys), jh, jsys))
    got = _raised(lambda: call(lambda: TTA(tsys, device="cpu"), th, tsys))
    if case == "UncoveredGroup":
        assert got == want == ("GroupError", "InvalidSelection")
    else:
        assert got == ("HBondError", case) and want[1] == case
