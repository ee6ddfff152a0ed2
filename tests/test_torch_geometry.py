"""Module-level parity of the observables' building blocks: the same
seeded numpy inputs through groan_rs_tpu and through the port on the CPU.

- `ops.geometry.angles` / `dihedrals` (atol 1e-4 degrees), including
  chains split by the periodic boundary;
- `ops.geometry.inside_shape` for every shape (exact), including points
  exactly on a shape boundary, and the refusal of a TriangularPrism;
- `ops.distances.pair_distance_histogram` (same group and cross group,
  the port chunked small enough to need several chunks) and
  `rdf_normalization`: counts equal, a pair may move one bin only when
  its distance lies within 1e-6 nm of a bin edge;
- `Topology.molecule_ids` on a random bond graph;
- `_hydrogen_mask` on its three rules: symbol, then mass, then name.
"""

import numpy as np
import pytest

from groan_rs_tpu.core import shapes as jshapes
from groan_rs_tpu.core.dimension import Dimension as JDim
from groan_rs_tpu.core.topology import StrColumn
from groan_rs_tpu.core.topology import Topology as JTopology
from groan_rs_tpu.errors import ShapeError as JShapeError
from groan_rs_tpu.models.pipeline import _hydrogen_mask as j_hydrogen_mask
from groan_rs_tpu.ops import distances as jdist
from groan_rs_tpu.ops import geometry as jgeo

from _torch_parity import n, t
from groan_rs_tpu_torch import testing
from groan_rs_tpu_torch.core import shapes as tshapes
from groan_rs_tpu_torch.core.dimension import Dimension as TDim
from groan_rs_tpu_torch.core.topology import Topology as TTopology
from groan_rs_tpu_torch.errors import AtomError, ShapeError
from groan_rs_tpu_torch.models.pipeline import _hydrogen_mask
from groan_rs_tpu_torch.ops import distances as tdist
from groan_rs_tpu_torch.ops import geometry as tgeo

BOX = np.asarray([[4.0, 5.0, 6.0], [4.5, 5.0, 5.5]], np.float32)


def _chains(k, links, seed):
    """[B, K, 3] starts plus `links` bonded steps of ~0.15 nm, wrapped
    into the box, so that many chains cross the periodic boundary."""
    rng = np.random.default_rng(seed)
    pts = [rng.uniform(0, 1, (2, k, 3)).astype(np.float32) * BOX[:, None, :]]
    for _ in range(links):
        step = rng.normal(size=(2, k, 3)).astype(np.float32) * np.float32(0.09)
        pts.append(((pts[-1] + step) % BOX[:, None, :]).astype(np.float32))
    return pts


def test_angles_and_dihedrals_match_jax():
    a, b, c, d = _chains(500, 3, seed=1)
    wrapped = np.abs(b - a).max(-1) > 1.0
    assert wrapped.sum() > 20  # chains split by the boundary are in the set
    ja = n(jgeo.angles(a, b, c, BOX))
    ta = n(tgeo.angles(t(a), t(b), t(c), t(BOX)))
    np.testing.assert_allclose(ta, ja, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ta, testing.angles_host_f64(a, b, c, BOX),
                               atol=2e-3, rtol=0)
    jd = n(jgeo.dihedrals(a, b, c, d, BOX))
    td = n(tgeo.dihedrals(t(a), t(b), t(c), t(d), t(BOX)))
    gap = (td - jd + 180.0) % 360.0 - 180.0
    assert np.abs(gap).max() <= 1e-4
    assert ta.min() >= 0 and ta.max() <= 180 and td.min() > -180 and td.max() <= 180


def test_moved_oracles_equal_jax_oracles():
    a, b, c, d = _chains(200, 3, seed=2)
    np.testing.assert_array_equal(testing.angles_host_f64(a, b, c, BOX),
                                  jgeo.angles_host_f64(a, b, c, BOX))
    np.testing.assert_array_equal(testing.dihedrals_host_f64(a, b, c, d, BOX),
                                  jgeo.dihedrals_host_f64(a, b, c, d, BOX))


def _shape_pair(kind, dim="Z"):
    pos = [1.0, 1.5, 2.0]
    if kind == "sphere":
        return jshapes.Sphere(pos, 1.25), tshapes.Sphere(pos, 1.25)
    if kind == "rect":
        return (jshapes.Rectangular(pos, 1.5, 2.5, 1.0),
                tshapes.Rectangular(pos, 1.5, 2.5, 1.0))
    return (jshapes.Cylinder(pos, 1.25, 2.5, getattr(JDim, dim)),
            tshapes.Cylinder(pos, 1.25, 2.5, getattr(TDim, dim)))


def _shape_points(seed):
    """Random points plus points exactly on the shapes' boundaries: at
    the anchor, anchor + each length, anchor +- radius along each axis
    and across the periodic image."""
    rng = np.random.default_rng(seed)
    rand = rng.uniform(-1, 7, (2, 400, 3)).astype(np.float32)
    pos = np.asarray([1.0, 1.5, 2.0], np.float32)
    edge = [pos]
    for ax in range(3):
        for off in (1.25, -1.25, 1.5, 2.5, 1.0, 4.0):
            p = pos.copy()
            p[ax] += np.float32(off)
            edge.append(p)
    edge = np.asarray(edge, np.float32)
    both = np.concatenate([rand, np.broadcast_to(edge, (2,) + edge.shape)], 1)
    return np.ascontiguousarray(both)


@pytest.mark.parametrize("kind,dim", [("sphere", "Z"), ("rect", "Z"),
                                      ("cyl", "X"), ("cyl", "Y"), ("cyl", "Z")])
def test_inside_shape_matches_jax(kind, dim):
    js, ts = _shape_pair(kind, dim)
    pts = _shape_points(seed=len(kind) + ord(dim))
    want = n(jgeo.inside_shape(js, pts, BOX))
    got = n(tgeo.inside_shape(ts, t(pts), t(BOX)))
    assert got.dtype == bool and got.shape == pts.shape[:2]
    assert np.array_equal(got, want)
    assert 0 < got.sum() < got.size


def test_prism_is_refused_and_shapes_keep_their_attributes():
    tri = ([1, 1, 1], [3, 1, 1], [1, 3, 1])
    with pytest.raises(JShapeError):
        jgeo.inside_shape(jshapes.TriangularPrism(*tri, 2.0),
                          np.zeros((1, 1, 3), np.float32), BOX[:1])
    prism = tshapes.TriangularPrism(*tri, 2.0)
    with pytest.raises(ShapeError):
        tgeo.inside_shape(prism, t(np.zeros((1, 1, 3), np.float32)), t(BOX[:1]))
    assert prism.get_orientation() is TDim.Z and prism.get_height() == 2.0
    with pytest.raises(ShapeError):
        tshapes.TriangularPrism([0, 0, 0], [1, 1, 1], [2, 0, 3], 1.0)
    cyl = tshapes.Cylinder([1, 2, 3], 0.5, 2.0, TDim.Y)
    assert cyl.get_plane() is TDim.XZ and cyl.get_radius() == 0.5
    assert np.array_equal(cyl.get_position(), [1, 2, 3])
    with pytest.raises(ShapeError):
        tshapes.Cylinder([0, 0, 0], 1.0, 1.0, TDim.XY)
    rect = tshapes.Rectangular([0, 0, 0], 1, 2, 3)
    assert (rect.get_x(), rect.get_y(), rect.get_z()) == (1.0, 2.0, 3.0)


def _near_edge_moves(got, want, d, dr):
    """Every bin-count difference is explained by pair distances within
    1e-6 nm of a bin edge."""
    near = np.abs(d / dr - np.round(d / dr)) * dr < 1e-6
    return np.abs(got - want).sum() <= 2 * near.sum()


@pytest.mark.parametrize("same", [False, True])
def test_pair_histogram_matches_jax(same):
    rng = np.random.default_rng(5 + same)
    box = np.asarray([[3.0, 3.5, 4.0], [3.2, 3.4, 3.6]], np.float32)
    a = rng.uniform(0, 1, (2, 90, 3)).astype(np.float32) * box[:, None, :]
    b = a if same else rng.uniform(0, 1, (2, 130, 3)).astype(np.float32) * box[:, None, :]
    # two coincident atoms: d == 0 is never counted
    b = b.copy()
    b[:, 7] = a[:, 3]
    r_max, n_bins = 1.5, 60
    want = n(jdist.pair_distance_histogram(a, b, box, r_max, n_bins,
                                           exclude_self=same))
    got = tdist.pair_distance_histogram(t(a), t(b), t(box), r_max, n_bins,
                                        exclude_self=same, chunk_pairs=500)
    assert got.dtype.is_floating_point is False and got.shape == (2, n_bins)
    got = n(got)
    dist = n(jdist.distance_matrix(a, b, box[:, None, :][:, 0, :]))
    assert _near_edge_moves(got, want, dist, r_max / n_bins)
    assert got.sum() > 100
    # a single chunk counts the same pairs
    one = n(tdist.pair_distance_histogram(t(a), t(b), t(box), r_max, n_bins,
                                          exclude_self=same))
    assert np.array_equal(one, got)
    jn = n(jdist.rdf_normalization(box, 90, b.shape[1], r_max, n_bins,
                                   exclude_self=same))
    tn = n(tdist.rdf_normalization(t(box), 90, b.shape[1], r_max, n_bins,
                                   exclude_self=same))
    np.testing.assert_allclose(tn, jn, rtol=1e-6)


def test_pair_histogram_oracle_bounds():
    rng = np.random.default_rng(9)
    box = np.asarray([[3.0, 3.5, 4.0]], np.float32)
    a = rng.uniform(0, 3, (1, 50, 3)).astype(np.float32)
    b = rng.uniform(0, 3, (1, 70, 3)).astype(np.float32)
    got = n(tdist.pair_distance_histogram(t(a), t(b), t(box), 1.5, 30))[0]
    lo, hi = testing.host_pair_histogram(a[0], b[0], box[0], 1.5, 30)
    assert (lo <= got).all() and (got <= hi).all() and lo.sum() > 100


def _bond_graph(n_atoms, seed):
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, n_atoms, (n_atoms // 2, 2))
    return pairs[pairs[:, 0] != pairs[:, 1]]


def test_molecule_ids_match_jax():
    n_atoms = 400
    pairs = _bond_graph(n_atoms, seed=11)
    jt = JTopology(n_atoms)
    jt.set_bonds_from_pairs(pairs)
    tt = TTopology(n_atoms)
    tt.set_bonds_from_pairs(pairs)
    assert np.array_equal(tt.molecule_ids(), jt.molecule_ids())
    assert tt.bonded == jt.bonded
    assert 1 < tt.molecule_ids().max() < n_atoms - 1
    tt.add_bond(0, n_atoms - 1)
    jt.add_bond(0, n_atoms - 1)
    assert np.array_equal(tt.molecule_ids(), jt.molecule_ids())
    assert np.array_equal(TTopology(5).molecule_ids(), np.arange(5))
    for i, j in ((3, 3), (0, n_atoms)):  # self bond, out of range
        with pytest.raises(Exception) as want:
            jt.add_bond(i, j)
        with pytest.raises(AtomError) as got:
            tt.add_bond(i, j)
        assert got.value.code == want.value.code


def test_hydrogen_mask_rules_match_jax():
    """Symbol first, then mass where the symbol is unset, then the first
    letter of the name ('1HH1' is a hydrogen)."""
    sym = ["H", "C", "", "", "", "", " h", "", "O"]
    mass = [12.0, 1.0, 1.008, 14.0, np.nan, np.nan, np.nan, np.nan, 16.0]
    has_mass = [True, True, True, True, False, False, False, False, True]
    names = ["C1", "H1", "C2", "H2", "1HH1", "CA", "X", "HW2", "OW"]
    jt = JTopology(len(sym))
    jt.element_symbol = StrColumn(values=np.asarray(sym))
    jt.atomname = StrColumn(values=np.asarray(names))
    jt.mass = np.asarray(mass, np.float32)
    jt.has_mass = np.asarray(has_mass)
    tt = TTopology(len(sym))
    tt.element_symbol = np.asarray(sym)
    tt.atomname = np.asarray(names)
    tt.mass = np.asarray(mass, np.float32)
    tt.has_mass = np.asarray(has_mass)
    want = j_hydrogen_mask(jt)
    got = _hydrogen_mask(tt)
    assert np.array_equal(got, want)
    assert got.tolist() == [True, False, True, False, True, False, True, True,
                            False]
