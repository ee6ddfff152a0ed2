"""The ported slice as a whole: TrajectoryAnalysis -> runner -> run on a
3,000-atom synthetic membrane-protein system, against groan_rs_tpu's
pipeline on the same System state and the same XTC.  com, distance and
RMSD within 1e-4, min distance within 1e-5, contacts exact, times and
steps exact; the device-resident re-runs equal the streamed pass within
float32 ulps (the JAX tiling contract, engine.py:933-938).

The pair threshold (2^24) is lowered to 1 in BOTH packages so that the
min-distance and contact observables take the pair-kernel branch at this
size, as they do at the 1M-atom main path."""

import numpy as np
import pytest
import torch

from groan_rs_tpu.models import TrajectoryAnalysis as JTA
from groan_rs_tpu.ops import distances as jdist

from _torch_parity import jax_system, state_from_jax_system
from groan_rs_tpu_torch import convert, testing
from groan_rs_tpu_torch.errors import ParallelError
from groan_rs_tpu_torch.io import native
from groan_rs_tpu_torch.models import TrajectoryAnalysis as TTA
from groan_rs_tpu_torch.ops import distances as tdist
from groan_rs_tpu_torch.ops import kernels as K

N_ATOMS, N_FRAMES = 3000, 10
GROUPS = ("Protein", "Membrane", "Peptide")
FLOATS = ("com", "dist", "rmsd", "mindist")


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    xtc = str(tmp_path_factory.mktemp("pipe") / "synthetic.xtc")
    testing.build_trajectory(xtc, N_ATOMS, N_FRAMES)
    offs, _, _, nat = native.xtc_scan(xtc)
    c0, b9, *_ = native.xtc_read_frames(xtc, offs[:1], nat)
    jsys = jax_system(testing.synthetic_state(c0[0], b9[0][[0, 4, 8]]))
    tsys = convert.system_from_state(state_from_jax_system(jsys, GROUPS))
    return xtc, jsys, tsys


@pytest.fixture
def pair_kernels(monkeypatch):
    monkeypatch.setattr(jdist, "_PAIR_TILE_THRESHOLD", 1)
    monkeypatch.setattr(tdist, "_PAIR_TILE_THRESHOLD", 1)


def _chain(pipe, system):
    return (pipe.add_com("Protein", name="com")
            .add_distance("Protein", "Membrane", com=(True, False), name="dist")
            .add_rmsd("Protein", reference=system, name="rmsd")
            .add_min_distance("Peptide", "Membrane", name="mindist")
            .add_contacts("Peptide", "Membrane", 0.5, name="contacts"))


def _port_runner(tsys):
    return _chain(TTA(tsys, device="cpu"), tsys).runner()


def _assert_ulps(got, want, maxulp=4):
    for k in FLOATS:
        np.testing.assert_array_max_ulp(got[k], want[k], maxulp=maxulp)
    assert np.array_equal(got["contacts"], want["contacts"])


def test_slice_matches_jax(systems, pair_kernels):
    xtc, jsys, tsys = systems
    want = _chain(JTA(jsys), jsys).runner().run(xtc, batch_size=2)
    K.reset_launch_counts()
    got = _port_runner(tsys).run(xtc, batch_size=2)
    assert all(v == 0 for v in K.launch_counts.values())  # CPU: twins only
    for k in FLOATS + ("contacts",):
        assert got[k].shape == np.asarray(want[k]).shape == (
            (N_FRAMES, 3) if k == "com" else (N_FRAMES,)), k
        assert np.isfinite(got[k]).all()
    np.testing.assert_allclose(got["com"], want["com"], atol=1e-4)
    np.testing.assert_allclose(got["dist"], want["dist"], atol=1e-4)
    np.testing.assert_allclose(got["rmsd"], want["rmsd"], atol=1e-4)
    np.testing.assert_allclose(got["mindist"], want["mindist"], atol=1e-5)
    assert np.array_equal(got["contacts"], np.asarray(want["contacts"]))
    assert got["contacts"].min() > 0
    assert np.array_equal(got["times"], want["times"])
    assert np.array_equal(got["steps"], want["steps"])
    assert got["rmsd"][0] < 1e-5 < got["rmsd"][1]


def test_slice_matches_float64_oracles(systems):
    """com / distance / RMSD / min distance against the float64 host
    references the chip smoke run uses (chip_smoke.py phase 4)."""
    xtc, _, tsys = systems
    got = _port_runner(tsys).run(xtc, batch_size=4)
    offs, _, _, nat = native.xtc_scan(xtc)
    coords, b9, *_ = native.xtc_read_frames(xtc, offs, nat)
    box = b9[0][[0, 4, 8]]
    n_prot, n_mem = testing.synthetic_sizes(N_ATOMS)
    w = tsys.topology.mass[:n_prot]
    for f in range(N_FRAMES):
        p = coords[f]
        ca = testing.host_refined_center(p[:n_prot], box, w)
        np.testing.assert_allclose(got["com"][f], ca, atol=1e-4)
        want = testing.host_min_distance(p[:n_prot], p[n_prot:n_prot + n_mem], box)
        assert abs(got["mindist"][f] - want) < 1e-5


@pytest.mark.parametrize("batch", [2, 4])
def test_resident_equals_streamed(systems, pair_kernels, batch):
    """load_device, then the per-batch and the fused resident passes; batch
    4 over 10 frames leaves a partial last batch (streamed: edge-padded;
    fused: repeat-padded) whose padding must be trimmed."""
    xtc, _, tsys = systems
    runner = _port_runner(tsys)
    streamed = runner.run(xtc, batch_size=batch)
    dt = runner.load_device(xtc, batch_size=batch)
    assert dt.kind == "q16" and dt.n_frames == N_FRAMES
    assert dt.pos.shape == (N_FRAMES, len(runner.sel), 3)
    per_batch = runner.engine.run_resident(dt, batch_size=batch)
    fused = runner.engine.run_resident_fused(dt, batch_size=batch)
    _assert_ulps(per_batch, streamed)
    _assert_ulps(fused, streamed)
    via_run = runner.run(dt, batch_size=batch)  # 5 or 3 batches: fused or not
    _assert_ulps(via_run, streamed)
    assert np.array_equal(via_run["times"], streamed["times"])


def test_ship_all_and_f32_wire_agree(systems):
    xtc, _, tsys = systems
    base = _port_runner(tsys).run(xtc, batch_size=3)
    pipe = _chain(TTA(tsys, device="cpu"), tsys)
    for kw in ({"ship": "all"}, {"wire": "f32"}):
        r = pipe.runner(**kw)
        out = r.run(xtc, batch_size=3)
        _assert_ulps(out, base)
    assert pipe.runner(ship="all").sel is None
    assert len(pipe.runner().sel) == 1300  # protein + membrane, contiguous


def test_resident_layout_is_checked(systems):
    xtc, _, tsys = systems
    dt = _port_runner(tsys).load_device(xtc, batch_size=5)
    other = TTA(tsys, device="cpu").add_com("Membrane").runner()
    with pytest.raises(ParallelError):
        other.run(dt)


def test_unported_features_raise(systems):
    """Meshes and other wires still raise; hydrogen bonds are ported
    (tests/test_torch_hbonds.py) and refuse what the JAX package refuses:
    the cell method on a resident window, the delta wire.  triclinic=True
    is ported and runs (tests/test_torch_triclinic_pipeline.py), and so are
    the velocity observables (tests/test_torch_velocity.py), which refuse
    an XTC as the JAX engine does: it carries no velocities."""
    from groan_rs_tpu_torch.errors import HBondError
    from groan_rs_tpu_torch.system.hbonds import HBondChain

    xtc, _, tsys = systems
    out = TTA(tsys, device="cpu", triclinic=True).add_com("Protein").runner().run(
        xtc, batch_size=5)
    assert out["com_Protein"].shape == (N_FRAMES, 3)
    assert np.isfinite(out["com_Protein"]).all()
    with pytest.raises(ParallelError, match="ROADMAP"):
        TTA(tsys, device="cpu", mesh=object())
    with pytest.raises(ParallelError, match="ROADMAP"):
        TTA(tsys, device="cpu").add_com("Protein").runner(wire="delta")
    hb = TTA(tsys, device="cpu").add_hbonds(
        [HBondChain("Peptide", "Peptide", "Peptide")], [(0, 0)], method="cells")
    runner = hb.runner()
    with pytest.raises(ParallelError, match="filename"):
        runner.run(runner.load_device(xtc, batch_size=5))
    with pytest.raises(HBondError) as e:
        hb.runner(wire="delta")
    assert e.value.code == "InvalidWire"
    for add in ("add_kinetic_energy", "add_temperature"):
        pipe = getattr(TTA(tsys, device="cpu"), add)("Protein")
        with pytest.raises(ParallelError, match="use TRR"):
            pipe.run(xtc, batch_size=5)
    with pytest.raises(ParallelError, match="use TRR"):
        TTA(tsys, device="cpu").add_com("Protein").runner(velocities=True).run(xtc)


def test_default_device_is_the_card(systems, monkeypatch):
    """TrajectoryAnalysis(system), the JAX package's signature, targets the
    CUDA card: with no card it raises require_cuda's RuntimeError -- not a
    TypeError, and no silent CPU run."""
    _, _, tsys = systems
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTA(tsys)
    assert TTA(tsys, device="cpu").device == torch.device("cpu")
