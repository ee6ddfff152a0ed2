"""The observables slice as a whole: every observable ported in this slice
configured on one TrajectoryAnalysis over a 3,000-atom synthetic system
with the full topology (charges, bonds, element symbols), 10 frames at
batch 2, through groan_rs_tpu's pipeline and through the port on the same
System state and the same XTC.

Tolerances: gyration, dipole, total dipole and order atol 1e-5; density
profiles, principal moments and g(r) rtol 1e-5; angles and dihedrals
atol 1e-3 degrees; density map, in-shape counts and box values exact;
order_pairs equal.  The resident passes and run_many equal the streamed
pass within float32 ulps; the error paths raise the JAX package's
exception class and code."""

import numpy as np
import pytest

from groan_rs_tpu.core.dimension import Dimension as JDim
from groan_rs_tpu.core.shapes import Cylinder as JCylinder
from groan_rs_tpu.core.shapes import TriangularPrism as JPrism
from groan_rs_tpu.models import TrajectoryAnalysis as JTA

from _torch_parity import jax_system, state_from_jax_system
from groan_rs_tpu_torch import convert, testing
from groan_rs_tpu_torch.core.dimension import Dimension as TDim
from groan_rs_tpu_torch.core.shapes import Cylinder as TCylinder
from groan_rs_tpu_torch.core.shapes import TriangularPrism as TPrism
from groan_rs_tpu_torch.errors import ParallelError
from groan_rs_tpu_torch.io import native
from groan_rs_tpu_torch.models import TrajectoryAnalysis as TTA
from groan_rs_tpu_torch.models import run_many

N_ATOMS, N_FRAMES = 3000, 10
GROUPS = ("Protein", "Membrane", "Peptide", "Water")
ATOL = {"gyration": 1e-5, "dipole": 1e-5, "total_dipole": 1e-5, "order": 1e-5,
        "angles": 1e-3, "dihedrals": 1e-3}
RTOL = ("profile_mass", "profile_charge", "principal", "rdf")
EXACT = ("density_map", "in_shape", "box_volume", "box_lengths")


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    xtc = str(tmp_path_factory.mktemp("obs") / "synthetic.xtc")
    testing.build_trajectory(xtc, N_ATOMS, N_FRAMES)
    offs, _, _, nat = native.xtc_scan(xtc)
    coords, b9, *_ = native.xtc_read_frames(xtc, offs, nat)
    boxes = b9[:, [0, 4, 8]]
    state = testing.synthetic_state(coords[0], boxes[0], topology="full")
    jsys = jax_system(state)
    tstate = state_from_jax_system(jsys, GROUPS)
    tstate["sites"] = state["sites"]
    tsys = convert.system_from_state(tstate)
    return xtc, coords, boxes, state, jsys, tsys


def _cyl(boxes, cls, dim):
    return cls(*testing.cylinder_args(boxes[0]), dim.Z)


def _port(tsys, state, boxes):
    return testing.add_observables(TTA(tsys, device="cpu"), state,
                                   _cyl(boxes, TCylinder, TDim))


def _assert_ulps(got, want, maxulp=4):
    for k, v in want.items():
        if k in ("times", "steps"):
            continue
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_array_max_ulp(got[k], v, maxulp=maxulp)
        else:
            assert np.array_equal(got[k], v), k


def test_observables_match_jax(systems):
    """Both packages on the f32 wire.  On the q16 wire the JAX package's
    jitted step gives dihedrals up to 0.015 degrees from the float64
    oracle on this input (its own dequantization, not the port's); the
    port's q16 results equal its f32 ones bit for bit
    (`test_q16_equals_f32`)."""
    xtc, _, boxes, state, jsys, tsys = systems
    jpipe = testing.add_observables(JTA(jsys), state, _cyl(boxes, JCylinder, JDim))
    want = jpipe.runner(wire="f32").run(xtc, batch_size=2)
    tpipe = _port(tsys, state, boxes)
    got = tpipe.runner(wire="f32").run(xtc, batch_size=2)
    names = set(ATOL) | set(RTOL) | set(EXACT)
    assert names <= set(got)
    for k in names:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        assert got[k].shape[0] == N_FRAMES
        if k in ATOL:
            np.testing.assert_allclose(got[k], w, atol=ATOL[k], rtol=0, err_msg=k)
        elif k in RTOL:
            np.testing.assert_allclose(got[k], w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(), err_msg=k)
        else:
            assert np.array_equal(got[k], w), k
    jc, jh = jpipe.order_pairs["order"]
    tc, th = tpipe.order_pairs["order"]
    assert np.array_equal(tc, jc) and np.array_equal(th, jh)
    assert got["rdf"].sum() > 0 and got["in_shape"].min() > 0
    assert got["density_map"].sum() == N_FRAMES * 1000


def _variants(pipe, shapes, dim):
    return (pipe.add_order("Membrane", axis=[1.0, 1.0, 0.0], name="order_v")
            .add_gyration("Protein", mass_weighted=False, name="gyr_geo")
            .add_principal("Protein", mass_weighted=False, name="pri_geo")
            .add_density_profile("Membrane", "x", 50, name="profile_n")
            .add_density_map("Water", "yz", tile=0.5,
                             span=((2.0, 12.0), (1.0, 19.0)), name="map_yz")
            .add_rdf("Peptide", "Peptide", r_max=1.5, n_bins=30, name="rdf_self")
            .add_in_shape("Water", shapes.Sphere([10.0, 10.0, 10.0], 3.0),
                          name="in_sphere")
            .add_in_shape("Membrane", shapes.Rectangular([15.0, 2.0, 9.0], 4.0,
                                                         6.0, 2.0),
                          name="in_box"))


def test_observable_options_match_jax(systems):
    from groan_rs_tpu.core import shapes as jshapes
    from groan_rs_tpu_torch.core import shapes as tshapes

    xtc, _, boxes, state, jsys, tsys = systems
    want = _variants(JTA(jsys), jshapes, JDim).runner(wire="f32").run(
        xtc, batch_size=4)
    got = _variants(TTA(tsys, device="cpu"), tshapes, TDim).runner(
        wire="f32").run(xtc, batch_size=4)
    for k in ("order_v", "gyr_geo"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)
    for k in ("pri_geo", "profile_n", "rdf_self"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    for k in ("map_yz", "in_sphere", "in_box"):
        assert got[k].dtype == np.asarray(want[k]).dtype
        assert np.array_equal(got[k], want[k]) and got[k].sum() > 0, k
    assert got["map_yz"].shape == (N_FRAMES, 20, 36)
    assert got["rdf_self"].sum() > 0


def test_q16_equals_f32(systems):
    xtc, _, boxes, state, _, tsys = systems
    pipe = _port(tsys, state, boxes)
    q16 = pipe.runner(wire="q16").run(xtc, batch_size=2)
    f32 = pipe.runner(wire="f32").run(xtc, batch_size=2)
    for k, v in f32.items():
        assert np.array_equal(q16[k], v), k


def test_observables_match_float64_oracles(systems):
    """The checks `chip_smoke.py` makes on the card, here at 3,000 atoms."""
    xtc, coords, boxes, state, _, tsys = systems
    out = _port(tsys, state, boxes).runner().run(xtc, batch_size=2)
    errs = testing.observable_errors(out, coords[:3], boxes[:3], state,
                                     _cyl(boxes, TCylinder, TDim))
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    assert not bad, bad


@pytest.mark.parametrize("batch", [2, 4])
def test_resident_equals_streamed(systems, batch):
    """Batch 4 over 10 frames leaves a partial last batch: edge-padded
    when streamed, repeat-padded when fused."""
    xtc, _, boxes, state, _, tsys = systems
    runner = _port(tsys, state, boxes).runner()
    assert runner.sel is None  # water is touched: every atom ships
    streamed = runner.run(xtc, batch_size=batch)
    dt = runner.load_device(xtc, batch_size=batch)
    _assert_ulps(runner.engine.run_resident(dt, batch_size=batch), streamed)
    _assert_ulps(runner.engine.run_resident_fused(dt, batch_size=batch), streamed)
    _assert_ulps(runner.run(dt, batch_size=batch), streamed)


def test_run_many_equals_individual_runs(systems):
    xtc, _, boxes, state, _, tsys = systems
    first = _port(tsys, state, boxes)
    second = (TTA(tsys, device="cpu").add_com("Protein", name="com")
              .add_rmsd("Protein", reference=tsys, name="rmsd")
              .add_box_lengths())
    dt = first.runner().load_device(xtc, batch_size=3)
    many = run_many([first, second.runner(ship="all")], dt, batch_size=3)
    assert len(many) == 2
    for pipe, got in zip((first, second), many):
        want = pipe.runner(ship="all").engine.run_resident(dt, batch_size=3)
        assert set(got) == set(want) | {"times", "steps"}
        for k, v in want.items():
            assert np.array_equal(got[k], v), k
        assert np.array_equal(got["times"], dt.times)
    assert np.array_equal(many[1]["box_lengths"], boxes)
    assert run_many([], dt) == []
    with pytest.raises(ParallelError):
        run_many([first], xtc)
    with pytest.raises(ParallelError):  # another layout than the window's
        run_many([TTA(tsys, device="cpu").add_com("Protein").runner()], dt)


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__, getattr(e, "code", None)
    return None


@pytest.mark.parametrize("case", [
    "missing_charge", "no_ch_bonds", "bad_profile_axis", "bad_order_axis",
    "bad_mode", "site_out_of_range", "bad_site_shape", "prism"])
def test_error_paths_match_jax(systems, case):
    _, _, boxes, state, jsys, tsys = systems
    n = N_ATOMS
    if case == "missing_charge":
        jsys.topology.has_charge[5] = tsys.topology.has_charge[5] = False
    calls = {
        "missing_charge": lambda p: p.add_dipole("Protein"),
        "no_ch_bonds": lambda p: p.add_order("Protein"),
        "bad_profile_axis": lambda p: p.add_density_profile("Water", axis="w"),
        "bad_order_axis": lambda p: p.add_order("Membrane", axis="q"),
        "bad_mode": lambda p: p.add_density_profile("Water", mode="volume"),
        "site_out_of_range": lambda p: p.add_angles([[0, 1, n]]),
        "bad_site_shape": lambda p: p.add_dihedrals([[0, 1, 2]]),
    }
    try:
        if case == "prism":
            tri = ([1, 1, 1], [3, 1, 1], [1, 3, 1])
            want = _raised(lambda: JTA(jsys).add_in_shape(
                "Water", JPrism(*tri, 2.0)))
            got = _raised(lambda: TTA(tsys, device="cpu").add_in_shape(
                "Water", TPrism(*tri, 2.0)))
        else:
            want = _raised(lambda: calls[case](JTA(jsys)))
            got = _raised(lambda: calls[case](TTA(tsys, device="cpu")))
    finally:
        jsys.topology.has_charge[5] = tsys.topology.has_charge[5] = True
    assert want is not None and got == want


def test_unported_still_raise(systems):
    """Meshes still raise; hydrogen bonds are ported (tests/test_torch_hbonds.py)
    and the cell method refuses a resident window in `run_many`, as in the
    JAX package; a triclinic observables pass is ported and runs
    (tests/test_torch_triclinic_pipeline.py); a velocity step over an XTC
    raises the JAX engine's error (no velocities in the file)."""
    from groan_rs_tpu_torch.system.hbonds import HBondChain

    xtc, *_, tsys = systems
    out = (TTA(tsys, device="cpu", triclinic=True).add_gyration("Protein")
           .add_box_volume().runner().run(xtc, batch_size=5))
    assert out["gyration_Protein"].shape == (N_FRAMES,)
    assert np.isfinite(out["gyration_Protein"]).all()
    assert out["box_volume"].shape == (N_FRAMES,)
    with pytest.raises(ParallelError, match="ROADMAP"):
        TTA(tsys, device="cpu", mesh=object())
    water = [HBondChain("name OW", "name OW", "name HW1 HW2")]
    cells = TTA(tsys, device="cpu").add_hbonds(water, [(0, 0)], method="cells")
    dt = TTA(tsys, device="cpu").add_com("Water").runner(ship="all").load_device(
        xtc, batch_size=5)
    with pytest.raises(ParallelError, match="filename"):
        run_many([cells], dt, batch_size=5)
    pipe = TTA(tsys, device="cpu").add_velocity_step(
        "vsum", lambda pos, vel, boxes, mask: vel.sum((1, 2)), touches="Protein")
    with pytest.raises(ParallelError, match="use TRR"):
        pipe.run(xtc, batch_size=5)
