"""The triclinic pass as a whole: a 3,000-atom synthetic system in an
xy-square rhombic dodecahedron (`testing.build_trajectory_triclinic`,
10 frames, the protein on a cell corner and the membrane on the plane
through it, so the cell's faces split both) through groan_rs_tpu's
`TrajectoryAnalysis(system, triclinic=True)` and through the port's on the
CPU, on the same System state and the same XTC.

Main path (the tolerances of `test_torch_pipeline.py`): com, distance and
RMSD within 1e-4, min distance within 1e-5, contacts exact.  Observables
(the tolerances of `test_torch_observables.py`, f32 wire): gyration,
dipole, total dipole and order atol 1e-5; density profiles, principal
moments and g(r) rtol 1e-5; angles and dihedrals atol 1e-3 degrees;
density map and box values exact.  On both wires the resident passes and
`run_many` equal the streamed pass within float32 ulps.  The error paths
raise the JAX package's exception class and code."""

import numpy as np
import pytest

from groan_rs_tpu.core.dimension import Dimension as JDim
from groan_rs_tpu.core.shapes import Cylinder as JCylinder
from groan_rs_tpu.models import TrajectoryAnalysis as JTA

from _torch_parity import jax_system, state_from_jax_system
from groan_rs_tpu_torch import convert, testing
from groan_rs_tpu_torch.core.dimension import Dimension as TDim
from groan_rs_tpu_torch.core.shapes import Cylinder as TCylinder
from groan_rs_tpu_torch.io import native
from groan_rs_tpu_torch.io.traj import traj_iter
from groan_rs_tpu_torch.models import TrajectoryAnalysis as TTA
from groan_rs_tpu_torch.models import run_many
from groan_rs_tpu_torch.ops import kernels as K

N_ATOMS, N_FRAMES = 3000, 10
GROUPS = ("Protein", "Membrane", "Peptide", "Water")
MAIN = ("com", "dist", "rmsd", "mindist", "contacts")
ATOL = {"gyration": 1e-5, "dipole": 1e-5, "total_dipole": 1e-5, "order": 1e-5,
        "angles": 1e-3, "dihedrals": 1e-3}
RTOL = ("profile_mass", "profile_charge", "principal", "rdf")
EXACT = ("density_map", "box_volume", "box_lengths")


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    xtc = str(tmp_path_factory.mktemp("tri") / "dodecahedron.xtc")
    testing.build_trajectory_triclinic(xtc, N_ATOMS, N_FRAMES)
    offs, _, _, nat = native.xtc_scan(xtc)
    coords, b9, *_ = native.xtc_read_frames(xtc, offs, nat)
    boxes = b9.reshape(-1, 3, 3)
    state = testing.synthetic_state(coords[0], boxes[0], topology="full")
    jsys = jax_system(state)
    tstate = state_from_jax_system(jsys, GROUPS)
    assert tstate["box"].shape == (3, 3)
    tstate["sites"] = state["sites"]
    tsys = convert.system_from_state(tstate)
    return xtc, coords, boxes, state, jsys, tsys


def _main(pipe, system):
    return (pipe.add_com("Protein", name="com")
            .add_distance("Protein", "Membrane", com=(True, False), name="dist")
            .add_rmsd("Protein", reference=system, name="rmsd")
            .add_min_distance("Peptide", "Membrane", name="mindist")
            .add_contacts("Peptide", "Membrane", 0.5, name="contacts"))


def _span(boxes):
    return ((0.0, float(boxes[0, 0, 0])), (0.0, float(boxes[0, 1, 1])))


def _observables(pipe, state, boxes):
    return testing.add_observables(pipe, state, None, span=_span(boxes))


@pytest.fixture(scope="module")
def streamed(systems):
    """The port's main and observables passes, streamed on both wires."""
    xtc, _, boxes, state, _, tsys = systems
    out = {}
    K.reset_launch_counts()
    for wire in ("q16", "f32"):
        main = _main(TTA(tsys, device="cpu", triclinic=True), tsys).runner(wire=wire)
        obs = _observables(TTA(tsys, device="cpu", triclinic=True), state,
                           boxes).runner(wire=wire)
        out[wire] = (main, main.run(xtc, batch_size=2), obs,
                     obs.run(xtc, batch_size=2))
    out["launches"] = dict(K.launch_counts)
    return out


def _assert_ulps(got, want, maxulp=4):
    for k, v in want.items():
        if k in ("times", "steps"):
            continue
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_array_max_ulp(got[k], v, maxulp=maxulp)
        else:
            assert np.array_equal(got[k], v), k


def test_main_path_matches_jax(systems, streamed):
    xtc, _, _, _, jsys, _ = systems
    want = _main(JTA(jsys, triclinic=True), jsys).runner().run(xtc, batch_size=2)
    _, got, _, _ = streamed["q16"]
    assert all(v == 0 for v in streamed["launches"].values())  # no kernel path
    for k in MAIN:
        assert got[k].shape == np.asarray(want[k]).shape == (
            (N_FRAMES, 3) if k == "com" else (N_FRAMES,)), k
        assert np.isfinite(got[k]).all(), k
    for k in ("com", "dist", "rmsd"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["mindist"], want["mindist"], atol=1e-5)
    assert np.array_equal(got["contacts"], np.asarray(want["contacts"]))
    assert got["contacts"].min() > 0
    assert np.array_equal(got["times"], want["times"])


def test_main_path_matches_float64_oracles(systems, streamed):
    """The checks `chip_smoke.py` phase 8 makes on the card, here at 3,000
    atoms: com, distance and RMSD within 2e-3, min distance within 1e-4,
    contacts inside the oracle's bounds."""
    _, coords, boxes, state, _, _ = systems
    _, got, _, _ = streamed["q16"]
    n_prot, n_mem = testing.synthetic_sizes(N_ATOMS)
    w = state["mass"][:n_prot]
    ref = state["positions"][:n_prot]
    for f in range(N_FRAMES):
        p, h = coords[f], boxes[f]
        ca = testing.host_refined_center_triclinic(p[:n_prot], h, w)
        cb = testing.host_refined_center_triclinic(p[n_prot:n_prot + n_mem], h)
        gap = testing.host_min_image_triclinic(got["com"][f] - ca, h)
        assert np.abs(gap).max() < 2e-3, f
        d = testing.host_min_image_triclinic(ca - cb, h)
        assert abs(got["dist"][f] - np.sqrt((d * d).sum())) < 2e-3, f
        want = testing.host_kabsch_rmsd_triclinic(ref, p[:n_prot], boxes[0], h, w)
        assert abs(got["rmsd"][f] - want) < 2e-3, f
    for f in range(2):
        best, lo, hi = testing.host_pairs_triclinic(
            coords[f][:min(400, n_prot)], coords[f][n_prot:n_prot + n_mem],
            boxes[f], 0.5)
        assert abs(got["mindist"][f] - best) < 1e-4
        assert lo <= got["contacts"][f] <= hi


def test_orthorhombic_treatment_differs(systems, streamed):
    """triclinic=False on this system reads the box as its diagonal (the
    JAX package's behaviour): frame 0's COM then lies more than 1 nm from
    the triclinic oracle's, which shows that the triclinic checks can fail."""
    xtc, coords, boxes, state, jsys, tsys = systems
    n_prot = testing.synthetic_sizes(N_ATOMS)[0]
    w = state["mass"][:n_prot]
    ortho = TTA(tsys, device="cpu").add_com("Protein", name="com").runner().run(
        xtc, batch_size=5)
    want = np.asarray(JTA(jsys).add_com("Protein", name="com").runner().run(
        xtc, batch_size=5)["com"])
    np.testing.assert_allclose(ortho["com"], want, atol=1e-4)
    ca = testing.host_refined_center_triclinic(coords[0][:n_prot], boxes[0], w)
    gap = testing.host_min_image_triclinic(ortho["com"][0] - ca, boxes[0])
    assert np.sqrt((gap * gap).sum()) > 1.0


def test_observables_match_jax(systems, streamed):
    xtc, _, boxes, state, jsys, _ = systems
    want = _observables(JTA(jsys, triclinic=True), state, boxes).runner(
        wire="f32").run(xtc, batch_size=2)
    *_, got = streamed["f32"]
    names = set(ATOL) | set(RTOL) | set(EXACT)
    assert names <= set(got) and "in_shape" not in got
    for k in names:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and got[k].shape[0] == N_FRAMES, k
        if k in ATOL:
            np.testing.assert_allclose(got[k], w, atol=ATOL[k], rtol=0, err_msg=k)
        elif k in RTOL:
            np.testing.assert_allclose(got[k], w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(), err_msg=k)
        else:
            assert np.array_equal(got[k], w), k
    assert got["rdf"].sum() > 0
    np.testing.assert_allclose(got["box_lengths"][0],
                               np.sqrt((boxes[0] ** 2).sum(-1)), rtol=1e-7)


def test_observables_match_float64_oracles(systems, streamed):
    """The checks `chip_smoke.py` phase 9 makes on the card."""
    _, coords, boxes, state, _, _ = systems
    _, _, _, got = streamed["q16"]
    errs = testing.observable_errors(got, coords[:2], boxes[:2], state, None,
                                     rdf_frames=1)
    assert "in_shape" not in errs
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    assert not bad, bad


@pytest.mark.parametrize("wire", ["q16", "f32"])
def test_q16_wire_holds_the_dodecahedron(systems, wire):
    """put_atoms_in_box keeps every coordinate inside the diagonal brick,
    so the q16 wire carries the whole file (no fallback to f32)."""
    xtc, _, _, _, _, tsys = systems
    kinds = {fb.wire for fb in traj_iter(tsys, xtc, batch_size=4).batches(wire=wire)}
    assert kinds == {wire}


@pytest.mark.parametrize("wire", ["q16", "f32"])
def test_resident_and_run_many_equal_streamed(systems, streamed, wire):
    """The observables window at batch 2 (5 batches: `run` takes the fused
    slabs) and the main path's at batch 4 (3 batches: `run` goes batch by
    batch); run_many over the observables' window, every atom shipped."""
    xtc, *_ = systems
    main, main_out, obs, obs_out = streamed[wire]
    dt = obs.load_device(xtc, batch_size=2)
    assert dt.kind == wire and dt.box_form == "matrix"
    assert tuple(dt.boxes.shape) == (N_FRAMES, 3, 3)
    per_batch = obs.engine.run_resident(dt, batch_size=2)
    _assert_ulps(per_batch, obs_out)
    _assert_ulps(obs.run(dt, batch_size=2), obs_out)
    main_dt = main.load_device(xtc, batch_size=4)
    _assert_ulps(main.run(main_dt, batch_size=4), main_out)
    _assert_ulps(main.engine.run_resident_fused(main_dt, batch_size=4), main_out)
    main_all = _main(TTA(main.system, device="cpu", triclinic=True),
                     main.system).runner(ship="all", wire=wire)
    many = run_many([obs, main_all], dt, batch_size=2)
    for k, v in per_batch.items():
        assert np.array_equal(many[0][k], v), k
    _assert_ulps(many[1], main_out)
    assert np.array_equal(many[1]["times"], main_out["times"])


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__, getattr(e, "code", None)
    return None


@pytest.mark.parametrize("case", ["in_shape", "distance_xy", "density_map_span"])
def test_error_paths_match_jax(systems, case):
    _, _, boxes, _, jsys, tsys = systems
    cyl = {"j": JCylinder([1.0, 1.0, 1.0], 1.0, 2.0, JDim.Z),
           "t": TCylinder([1.0, 1.0, 1.0], 1.0, 2.0, TDim.Z)}
    dims = {"j": JDim, "t": TDim}
    calls = {
        "in_shape": lambda p, s: p.add_in_shape("Water", cyl[s]),
        "distance_xy": lambda p, s: p.add_distance("Protein", "Membrane",
                                                   dim=dims[s].XY),
        "density_map_span": lambda p, s: p.add_density_map("Membrane"),
    }
    want = _raised(lambda: calls[case](JTA(jsys, triclinic=True), "j"))
    got = _raised(lambda: calls[case](TTA(tsys, device="cpu", triclinic=True), "t"))
    assert want is not None and got == want
