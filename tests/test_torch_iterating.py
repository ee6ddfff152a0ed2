"""Atom iterators, shapes, group-by-geometry and the cell grid's neighbour
iterator of the PyTorch port against the JAX package, on the 3,000-atom
synthetic system (full topology) on the CPU.

Membership (`inside`, `inside_naive`, `filter_geometry`,
`group_create_from_geometry`) is exact for every atom farther than 1e-5
nm from the shape's boundary (a float64 margin decides which atoms are
that close); centres of iterators within 2e-4 (refined) and 1e-4
(estimated), plain means 1e-5; atom views, orders and bonds exact."""

import numpy as np
import pytest
import torch

from groan_rs_tpu.core import shapes as jshapes
from groan_rs_tpu.core.cellgrid import CellGrid as JCellGrid
from groan_rs_tpu.core.dimension import Dimension as JDim
from groan_rs_tpu.system.iterating import intersection_iter as jinter
from groan_rs_tpu.system.iterating import union_iter as junion

from _torch_parity import synthetic_pair
from groan_rs_tpu_torch.core import shapes as tshapes
from groan_rs_tpu_torch.core.cellgrid import CellGrid as TCellGrid
from groan_rs_tpu_torch.core.dimension import Dimension as TDim
from groan_rs_tpu_torch.system.iterating import intersection_iter as tinter
from groan_rs_tpu_torch.system.iterating import union_iter as tunion

BOX = 21.0


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return synthetic_pair(tmp_path_factory.mktemp("iter") / "synthetic.xtc", n_frames=2)[1:]


@pytest.fixture
def fresh(pair):
    js, ts = pair
    return js.copy(), ts.copy()


# (class name, arguments with "Dim.<axis>" for the orientation); shapes that
# cross the box edges, so the PBC forms matter
SHAPES = [
    ("Sphere", ([20.0, 1.0, 10.5], 4.0)),
    ("Sphere", ([10.5, 10.5, 10.5], 3.3)),
    ("Rectangular", ([18.0, 19.0, 2.0], 6.0, 5.0, 8.0)),
    ("Rectangular", ([1.0, 2.0, 3.0], 10.0, 2.5, 4.0)),
    ("Cylinder", ([1.0, 20.0, 17.0], 3.0, 9.0, "Z")),
    ("Cylinder", ([10.0, 4.0, 10.0], 5.0, 4.0, "X")),
    ("Cylinder", ([12.0, 19.0, 0.5], 2.5, 30.0, "Y")),
    ("TriangularPrism", ([2.0, 3.0, 18.0], [15.0, 4.0, 18.0], [6.0, 16.0, 18.0], 7.0)),
    ("TriangularPrism", ([5.0, 2.0, 3.0], [5.0, 15.0, 4.0], [5.0, 6.0, 19.0], 4.0)),
]


def _shape(mod, dim, spec):
    name, args = spec
    args = tuple(getattr(dim, a) if isinstance(a, str) else a for a in args)
    return getattr(mod, name)(*args)


def _margin(spec, p, naive):
    """float64 signed distance of each point to the shape's boundary
    (positive inside), per the shapes' definitions."""
    name, args = spec
    p = np.asarray(p, np.float64)
    L = np.full(3, BOX)

    def axis_d(ax, anchor):
        d = p[:, ax] - anchor
        if naive:
            return d
        d = d - L[ax] * np.round(d / L[ax])
        return np.where(d < 0, d + L[ax], d)

    def plane_r(center, dims):
        d = p - np.asarray(center, np.float64)
        if not naive:
            d = d - L * np.round(d / L)
        return np.sqrt((d[:, list(dims)] ** 2).sum(1))

    if name == "Sphere":
        return args[1] - plane_r(args[0], (0, 1, 2))
    if name == "Rectangular":
        pos, ext = args[0], args[1:]
        ds = [axis_d(ax, pos[ax]) for ax in range(3)]
        return np.min([np.minimum(d, e - d) for d, e in zip(ds, ext)], axis=0)
    if name == "Cylinder":
        pos, r, h, ori = args
        ax = "XYZ".index(ori)
        d = axis_d(ax, pos[ax])
        return np.minimum(np.minimum(d, h - d),
                          r - plane_r(pos, [i for i in range(3) if i != ax]))
    b = [np.asarray(v, np.float64) for v in args[:3]]
    ax = next(a for a in range(3) if b[0][a] == b[1][a] == b[2][a])
    i, j = [k for k in range(3) if k != ax]
    d = axis_d(ax, b[0][ax])
    edges = []
    for a, c in ((b[0], b[1]), (b[1], b[2]), (b[2], b[0])):
        s = ((p[:, i] - c[i]) * (a[j] - c[j]) - (a[i] - c[i]) * (p[:, j] - c[j]))
        edges.append(s / np.hypot(a[i] - c[i], a[j] - c[j]))
    e = np.stack(edges)
    inner = np.where((e >= 0).all(0), e.min(0), np.where((e <= 0).all(0), (-e).min(0),
                                                           -np.abs(e).min(0)))
    return np.minimum(np.minimum(d, args[3] - d), inner)


def _points():
    rng = np.random.default_rng(8)
    p = rng.uniform(-4.0, BOX + 4.0, (20000, 3)).astype(np.float32)
    return p


@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("spec", SHAPES, ids=[f"{s[0]}{i}" for i, s in enumerate(SHAPES)])
def test_inside_matches_jax(spec, naive):
    js, ts = _shape(jshapes, JDim, spec), _shape(tshapes, TDim, spec)
    p = _points()
    box = np.full(3, BOX, np.float32)
    if naive and spec[0] == "TriangularPrism":
        for s, arg in ((js, p), (ts, torch.from_numpy(p))):
            with pytest.raises(NotImplementedError):
                s.inside_naive(arg)
        return
    want = np.asarray(js.inside_naive(p) if naive else js.inside(p, box))
    got = ts.inside_naive(torch.from_numpy(p)) if naive else ts.inside(
        torch.from_numpy(p), torch.from_numpy(box))
    assert got.dtype == torch.bool and got.shape == (p.shape[0],)
    got = got.numpy()
    far = np.abs(_margin(spec, p, naive)) > 1e-5
    assert np.array_equal(got[far], want[far])
    assert want[far].any() and (~want[far]).any()
    # the float64 margin's own sign agrees away from the boundary
    assert np.array_equal(got[far], _margin(spec, p, naive)[far] > 0)


@pytest.mark.parametrize("spec", SHAPES[::2], ids=[f"{s[0]}{i}" for i, s in enumerate(SHAPES[::2])])
def test_filter_geometry_and_groups_match_jax(fresh, spec):
    js, ts = fresh
    jsh, tsh = _shape(jshapes, JDim, spec), _shape(tshapes, TDim, spec)
    far = np.abs(_margin(spec, ts.positions, False)) > 1e-5
    near = np.nonzero(~far)[0]

    def same(a, b):
        assert np.array_equal(np.setdiff1d(a, near), np.setdiff1d(b, near))

    jit = js.group_iter("Membrane").filter_geometry(jsh)
    tit = ts.group_iter("Membrane").filter_geometry(tsh)
    same(tit.indices, jit.indices)
    if not tit.indices.size:
        return
    np.testing.assert_allclose(tit.get_com(), jit.get_com(), rtol=0, atol=2e-4)
    np.testing.assert_allclose(tit.estimate_center(), jit.estimate_center(), rtol=0, atol=1e-4)
    same(ts.atoms_filter_geometry(tsh), js.atoms_filter_geometry(jsh))
    same(ts.group_filter_geometry("Water", tsh), js.group_filter_geometry("Water", jsh))
    for s, sh in ((js, jsh), (ts, tsh)):
        s.group_create_from_geometry("Inside", "@water or resid 1 to 300", sh)
        s.group_create_from_geometries("Both", "all", [sh, sh])
    same(ts.group_indices("Inside"), js.group_indices("Inside"))
    same(ts.group_indices("Both"), js.group_indices("Both"))
    if spec[0] != "TriangularPrism":
        same(ts.atoms_iter().filter_geometry_naive(tsh).indices,
             js.atoms_iter().filter_geometry_naive(jsh).indices)


AGG = [("get_center", 2e-4), ("get_com", 2e-4), ("estimate_center", 1e-4),
       ("estimate_com", 1e-4), ("get_center_naive", 1e-5), ("get_com_naive", 1e-5)]


@pytest.mark.parametrize("name,tol", AGG)
@pytest.mark.parametrize("make", ["group", "selection", "union", "intersection"])
def test_iterator_aggregates_match_jax(pair, make, name, tol):
    def it(s):
        if make == "group":
            return s.group_iter("Protein")
        if make == "selection":
            return s.selection_iter("serial 1 to 150 or serial 1200 to 1290")
        if make == "union":
            return s.group_iter("Peptide").union(s.group_iter("Water"))
        return s.group_iter("Protein").intersection(s.selection_iter("serial 50 to 5000"))

    js, ts = pair
    ji, ti = it(js), it(ts)
    assert np.array_equal(ti.indices, ji.indices)
    np.testing.assert_allclose(getattr(ti, name)(), getattr(ji, name)(), rtol=0, atol=tol)


def test_atom_views_and_iteration_match_jax(fresh):
    js, ts = fresh
    fields = ("get_index", "get_residue_number", "get_atom_number", "get_atom_name",
              "get_mass", "get_charge", "get_element_symbol", "get_position",
              "has_position", "get_n_bonded")

    def rows(atoms):
        return [tuple(np.asarray(getattr(a, f)()).tolist() for f in fields) for a in atoms]

    assert rows(ts.group_iter("Peptide")) == rows(js.group_iter("Peptide"))
    assert rows(ts.atoms_iter()) == rows(js.atoms_iter())
    a, b = ts.get_atom(1500), js.get_atom(1500)
    assert a.distance(ts.get_atom(2), TDim.XY, ts.get_box()) == pytest.approx(
        b.distance(js.get_atom(2), JDim.XY, js.get_box()), abs=1e-6)
    for s in (js, ts):
        at = s.get_atom(1501)
        at.set_position([30.0, -1.0, 5.0])
        at.wrap(s.get_box())
        at.translate([1.0, 25.0, 0.0], s.get_box())
        at.set_mass(3.5)
        at.reset_bonded()
    assert np.array_equal(ts.positions, js.positions)
    assert ts.get_atom(1501).get_mass() == js.get_atom(1501).get_mass() == 3.5
    assert [list(x) for x in ts.topology.bonded[1499:1503]] == js.topology.bonded[1499:1503]


@pytest.mark.parametrize("index", [0, 1300, 1301, 1305, 2998])
def test_bond_iterators_match_jax(pair, index):
    js, ts = pair

    def ids(atoms):
        return [a.get_index() for a in atoms]

    assert ids(ts.bonded_atoms_iter(index)) == ids(js.bonded_atoms_iter(index))
    assert ids(ts.molecule_iter(index)) == ids(js.molecule_iter(index))
    assert ts.get_molecule_indices(index) == js.get_molecule_indices(index)
    assert [(a.get_index(), b.get_index()) for a, b in ts.molecule_bonds_iter(index)] == \
        [(a.get_index(), b.get_index()) for a, b in js.molecule_bonds_iter(index)]


def test_pair_union_intersection_iterators_match_jax(pair):
    js, ts = pair
    pairs = [(0, 5), (2999, 1), (1300, 1301)]
    assert [(a.get_index(), b.get_index()) for a, b in ts.atom_pairs_iter(pairs)] == pairs
    for tf, jf in ((tunion, junion), (tinter, jinter)):
        got = [a.get_index() for a in tf(ts.group_iter("Peptide"),
                                         ts.selection_iter("serial 300 to 900"))]
        want = [a.get_index() for a in jf(js.group_iter("Peptide"),
                                          js.selection_iter("serial 300 to 900"))]
        assert got == want and got
    assert [a.get_index() for a in ts.group_union_iter("Peptide", "Water")] == \
        [a.get_index() for a in js.group_union_iter("Peptide", "Water")]
    assert [a.get_index() for a in ts.group_intersection_iter("Protein", "Peptide")] == \
        [a.get_index() for a in js.group_intersection_iter("Protein", "Peptide")]


def test_iterator_translate_and_wrap_match_jax(fresh):
    js, ts = fresh
    for s in (js, ts):
        s.group_iter("Peptide").translate([12.0, -30.5, 7.25])
        s.selection_iter("serial 2000 to 2100").wrap()
    np.testing.assert_allclose(ts.positions, js.positions, rtol=0, atol=1e-5)


@pytest.mark.parametrize("point", [[1.0, 1.0, 1.0], [20.9, 0.1, 10.0], [-3.0, 25.0, 5.0]])
@pytest.mark.parametrize("cell", [1.0, 2.5])
def test_neighbors_iter_matches_jax(pair, point, cell):
    js, ts = pair
    jit = JCellGrid(js, "all", cell).neighbors_iter(point, x_range=(-2, 2))
    tit = TCellGrid(ts, "all", cell).neighbors_iter(point, x_range=(-2, 2))
    assert np.array_equal(tit.indices, jit.indices) and tit.indices.size
    np.testing.assert_allclose(tit.get_center(), jit.get_center(), rtol=0, atol=2e-4)
