"""The System's analysis, triclinic analysis and utility methods of the
PyTorch port against the JAX System on the 3,000-atom synthetic system
(full topology), on the CPU (`device="cpu"`: the K1 and K2 twins).

Tolerances: estimated centres 1e-4 and refined centres 2e-4 (as
tests/test_pallas_kernels.py allows), plain means and distances 1e-5;
the error classes' codes equal the JAX package's.  The System computes
on the card unless asked for the CPU: built without a device, it raises
at its first computing call on a host without one."""

import warnings

import numpy as np
import pytest
import torch

from groan_rs_tpu.core.dimension import Dimension as JDim
from groan_rs_tpu.core.simbox import SimBox as JSimBox
from groan_rs_tpu.errors import GroanError as JGroanError
from groan_rs_tpu.system import analysis as janalysis

from _torch_parity import synthetic_pair
from groan_rs_tpu_torch import System, testing
from groan_rs_tpu_torch.core.dimension import Dimension as TDim
from groan_rs_tpu_torch.core.simbox import SimBox as TSimBox
from groan_rs_tpu_torch.core.topology import Topology
from groan_rs_tpu_torch.errors import GroanError, PerformanceWarning
from groan_rs_tpu_torch.ops import kernels as K
from groan_rs_tpu_torch.system import analysis as tanalysis


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return synthetic_pair(tmp_path_factory.mktemp("api") / "synthetic.xtc", n_frames=2)[1:]


@pytest.fixture
def fresh(pair):
    js, ts = pair
    return js.copy(), ts.copy()


def _dim(name):
    return getattr(JDim, name), getattr(TDim, name)


# (method, arguments: "Dim" is replaced by each package's Dimension, tolerance)
CALLS = [
    ("group_estimate_center", ("Protein",), 1e-4),
    ("group_estimate_center", ("Membrane",), 1e-4),
    ("group_get_center", ("Protein",), 2e-4),
    ("group_get_center", ("Water",), 2e-4),
    ("group_get_center_naive", ("Membrane",), 1e-5),
    ("group_estimate_com", ("Protein",), 1e-4),
    ("group_get_com", ("Protein",), 2e-4),
    ("group_get_com", ("Membrane",), 2e-4),
    ("group_get_com_naive", ("Peptide",), 1e-5),
    ("group_distance", ("Protein", "Membrane", "XYZ"), 1e-5),
    ("group_distance", ("Peptide", "Membrane", "Z"), 1e-5),
    ("group_distance", ("Peptide", "Water", "XY"), 1e-5),
    ("group_all_distances", ("Peptide", "Protein", "XYZ"), 1e-5),
    ("group_all_distances", ("Peptide", "Membrane", "X"), 1e-5),
    ("atoms_distance", (3, 2500, "XYZ"), 1e-5),
    ("atoms_distance", (17, 1400, "YZ"), 1e-5),
    ("group_get_center_triclinic", ("Protein",), 2e-4),
    ("group_get_com_triclinic", ("Membrane",), 2e-4),
    ("group_distance_triclinic", ("Peptide", "Membrane"), 1e-5),
    ("atoms_distance_triclinic", (3, 2500), 1e-5),
]


def _args(args, which):
    return tuple(_dim(a)[which] if a in ("XYZ", "X", "Y", "Z", "XY", "YZ", "XZ") else a
                 for a in args)


# the triclinic methods also in a triclinic box (the others refuse one:
# test_errors_match_jax)
CASES = [(m, a, t, "orthorhombic") for m, a, t in CALLS] + [
    (m, a, t, "triclinic") for m, a, t in CALLS if "triclinic" in m]


@pytest.mark.parametrize("method,args,tol,box", CASES,
                         ids=[f"{m}-{'-'.join(map(str, a))}-{b}" for m, a, _, b in CASES])
def test_analysis_matches_jax(fresh, method, args, tol, box):
    js, ts = fresh
    if box == "triclinic":
        h = testing.dodecahedron(10.0)
        js.set_box(JSimBox.from_matrix(h))
        ts.set_box(TSimBox.from_matrix(h))
    want = np.asarray(getattr(js, method)(*_args(args, 0)), np.float64)
    K.reset_launch_counts()
    got = np.asarray(getattr(ts, method)(*_args(args, 1)), np.float64)
    assert all(v == 0 for v in K.launch_counts.values())  # CPU: the twins
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _break(js, ts, case):
    """Make both systems fail the same way -> the call to make."""
    if case == "NoGroup":
        return lambda s, D: s.group_get_com("Nonexistent")
    if case == "NoBox":
        js.set_box(None)
        ts.set_box(None)
        return lambda s, D: s.group_get_center("Protein")
    if case == "Triclinic":
        js.set_box(JSimBox.from_matrix(testing.dodecahedron(10.0)))
        ts.set_box(TSimBox.from_matrix(testing.dodecahedron(10.0)))
        return lambda s, D: s.group_distance("Protein", "Membrane", D.XYZ)
    if case == "NoMass":
        for s in (js, ts):
            s.topology.has_mass[5] = False
        return lambda s, D: s.group_get_com("Protein")
    if case == "NoPosition":
        for s in (js, ts):
            s.has_position[7] = False
        return lambda s, D: s.group_estimate_center("Protein")
    if case == "AtomOutOfRange":
        return lambda s, D: s.atoms_distance(0, 10**6, D.XYZ)
    if case == "AtomWithoutPosition":
        for s in (js, ts):
            s.has_position[9] = False
        return lambda s, D: s.atoms_distance(0, 9, D.XYZ)
    if case == "TriclinicNoBox":
        js.set_box(None)
        ts.set_box(None)
        return lambda s, D: s.group_get_center_triclinic("Protein")
    if case == "EmptyCentring":
        for s in (js, ts):
            s.group_create_from_indices("Empty", [])
        return lambda s, D: s.atoms_center("Empty", D.XYZ)
    if case == "BadLabel":
        return lambda s, D: s.label_atom("bad name!", 3)
    if case == "LabelOutOfRange":
        return lambda s, D: s.label_atom("far", 10**6)
    if case == "LabelQueryCount":
        return lambda s, D: s.select_and_label("many", "resid 1 to 3")
    if case == "LabelBadQuery":
        return lambda s, D: s.select_and_label("q", "resid 1 (")
    if case == "UnknownLabel":
        return lambda s, D: s.get_labeled_atom("nobody")
    raise AssertionError(case)


ERRORS = ["NoGroup", "NoBox", "Triclinic", "NoMass", "NoPosition", "AtomOutOfRange",
          "AtomWithoutPosition", "TriclinicNoBox", "EmptyCentring", "BadLabel",
          "LabelOutOfRange", "LabelQueryCount", "LabelBadQuery", "UnknownLabel"]


@pytest.mark.parametrize("case", ERRORS)
def test_errors_match_jax(fresh, case):
    js, ts = fresh
    call = _break(js, ts, case)
    with pytest.raises(JGroanError) as je:
        call(js, JDim)
    with pytest.raises(GroanError) as te:
        call(ts, TDim)
    assert type(te.value).__name__ == type(je.value).__name__
    assert te.value.code == je.value.code


@pytest.mark.parametrize("method,group", [("atoms_center", "Protein"),
                                          ("atoms_center", "Peptide"),
                                          ("atoms_center_mass", "Membrane")])
@pytest.mark.parametrize("dim", ["XYZ", "Z", "XY"])
def test_centring_matches_jax(fresh, method, group, dim):
    js, ts = fresh
    getattr(js, method)(group, getattr(JDim, dim))
    getattr(ts, method)(group, getattr(TDim, dim))
    np.testing.assert_allclose(ts.positions, js.positions, rtol=0, atol=1e-5)


def test_labels_match_jax(fresh):
    js, ts = fresh
    for s in (js, ts):
        s.label_atom("first", 0)
        s.select_and_label("tenth", "serial 10")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            s.label_atom("first", 4)
        assert len(caught) == 1
    assert ts.labeled_atoms == js.labeled_atoms == {"first": 4, "tenth": 9}
    assert ts.get_labeled_atom("tenth").get_index() == 9
    assert [(k, a.get_index()) for k, a in ts.labeled_atoms_iter()] == \
        [(k, a.get_index()) for k, a in js.labeled_atoms_iter()]
    ts.unlabel_atom("first")
    assert not ts.label_exists("first") and ts.label_exists("tenth")


def test_dispatch_guard_warns_once(fresh):
    _, ts = fresh
    tanalysis._reset_dispatch_guard(3)
    janalysis._reset_dispatch_guard(3)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(5):
                ts.group_get_center("Peptide")
        assert [w.category for w in caught] == [PerformanceWarning]
        assert "TrajectoryAnalysis" in str(caught[0].message)
    finally:
        tanalysis._reset_dispatch_guard(256)
        janalysis._reset_dispatch_guard(256)


def test_device_defaults_to_the_card(monkeypatch, tmp_path):
    """A System built without a device computes on the CUDA card: with no
    card, `group_get_com` (and every computing method) raises
    require_cuda's RuntimeError, with no quiet CPU run; `device="cpu"`
    and `set_device("cpu")` are the one spelling of the CPU."""
    n = 60
    topo = Topology.from_columns(np.arange(n) // 3 + 1, ["SOL"] * n,
                                 ["OW", "HW1", "HW2"] * (n // 3), np.arange(1, n + 1))
    pos = np.random.default_rng(2).uniform(0, 3, (n, 3)).astype(np.float32)
    path = tmp_path / "small.gro"
    System("small", topo, TSimBox.from_lengths(3.0, 3.0, 3.0), positions=pos).write_gro(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = System.from_file(path)
    s.guess_elements()  # masses for the COM
    s.group_create("Some", "serial 1 to 40")
    for call in (lambda: s.group_get_com("all"), lambda: s.group_get_center("Some"),
                 lambda: s.atoms_translate([1.0, 0.0, 0.0])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert System.from_file(path, device="cpu").device == torch.device("cpu")
    s.set_device("cpu")
    assert s.device == torch.device("cpu")
    assert np.isfinite(s.group_get_center("Some")).all()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        s.set_device("cuda")


@pytest.mark.parametrize("name", [d.name for d in JDim])
def test_dimension_matches_jax(name):
    j, t = getattr(JDim, name), getattr(TDim, name)
    assert (t.is_x, t.is_y, t.is_z, t.is_none, t.n_axes) == \
        (j.is_x, j.is_y, j.is_z, j.is_none, j.n_axes)
    assert np.array_equal(t.mask(), j.mask()) and t.mask().dtype == j.mask().dtype
    assert np.array_equal(t.to_unit_vector(), j.to_unit_vector())
    assert TDim.from_string(f" {name.lower()} ") is t
    assert TDim.from_flags(*t.value) is t and str(t) == str(j)


VECTOR_CALLS = {
    "len": lambda v, o, b, D: v.len(),
    "angle": lambda v, o, b, D: v.angle(o),
    "dot": lambda v, o, b, D: v.dot(o),
    "cross": lambda v, o, b, D: v.cross(o),
    "to_unit": lambda v, o, b, D: v.to_unit(),
    "invert": lambda v, o, b, D: v.invert(),
    "rotate": lambda v, o, b, D: v.rotate(np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]],
                                                    np.float32)),
    "shift": lambda v, o, b, D: v.shift(o, 2.75),
    "wrap": lambda v, o, b, D: v.wrap(b),
    "filter": lambda v, o, b, D: v.filter(D.XZ),
    "distance": lambda v, o, b, D: v.distance(o, D.XYZ, b),
    "distance_y": lambda v, o, b, D: v.distance(o, D.Y, b),
    "distance_naive": lambda v, o, b, D: v.distance_naive(o, D.XY),
    "vector_to": lambda v, o, b, D: v.vector_to(o, b),
    "average": lambda v, o, b, D: type(v).average([v, o, o]),
}


@pytest.mark.parametrize("name", sorted(VECTOR_CALLS))
@pytest.mark.parametrize("pair", [([1.5, -2.0, 30.25], [20.0, 4.0, -0.5]),
                                  ([10.5, 0.0, 10.5], [0.0, 21.0, 0.0])])
def test_vector3d_matches_jax(name, pair):
    from groan_rs_tpu.core.vector3d import Vector3D as JVec

    from groan_rs_tpu_torch.core.vector3d import Vector3D as TVec

    out = []
    for Vec, Box, D in ((JVec, JSimBox, JDim), (TVec, TSimBox, TDim)):
        v, o = Vec(*pair[0]), Vec(*pair[1])
        out.append(np.asarray(VECTOR_CALLS[name](v, o, Box.from_lengths(21.0, 21.0, 21.0),
                                                 D), np.float64))
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6, atol=1e-6)
