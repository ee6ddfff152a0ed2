"""Dynamic selections, solvent ordering and the periodic-image distance in
the PyTorch port against the JAX package: `models.select_dynamic`,
`models.trjorder`, `models.pi_mindist` and `ops.distances.self_image_min`.

The same XTC through both packages: the named 3,000-atom synthetic layout
in a cube and a rhombic dodecahedron (`_torch_parity.geometry_pairs`) and
the JAX tests' constructions.  Tolerances from the JAX tests
(`test_pi_mindist.py`, `test_trjorder_hydorder.py`,
`test_select_dynamic.py`): 1e-6 nm for exact constructions, rtol 2e-5 /
atol 1e-5 against the float64 26-image oracle, 2e-4 nm for trjorder
distances against constructions.  Port against JAX: selection masks
equal; self-image distances within 1e-6 (relative 1e-6: XLA may contract
the sums of squares into fused multiply-adds, a one-ulp gap); trjorder
distances within 1e-5 nm, and its order equal except between molecules
whose JAX distances lie within ORDER_BOUND of each other: the two
packages build d^2 in float32 through different compilers (XLA may
contract and reorder), measured up to 9e-7 nm apart on this layout."""

import numpy as np
import pytest
import torch

from _torch_parity import frames_pair, geometry_pairs, raised
from groan_rs_tpu import models as jm
from groan_rs_tpu.ops import distances as jd
from groan_rs_tpu_torch import models as tm
from groan_rs_tpu_torch.ops import distances as td

ORDER_BOUND = 2e-6   # nm: float32 reach of two compilers' d between two molecules


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return geometry_pairs(tmp_path_factory)


FORMS = ["ortho", "triclinic"]


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], want[k]), k


# ------------------------------------------------------------ select_dynamic

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("within,whole_res,chunk", [(0.4, False, 8192), (0.35, True, 100),
                                                    (0.6, True, 7)])
def test_select_within(pairs, form, within, whole_res, chunk):
    xtc, js, ts = pairs[form]
    got = tm.select_dynamic(ts, xtc, "Water", within=within, of="Protein",
                            whole_res=whole_res, chunk=chunk)
    want = jm.select_dynamic(js, xtc, "Water", within=within, of="Protein",
                             whole_res=whole_res)
    _same(got, want)
    assert got["sizes"].min() > 0


def _shapes():
    from groan_rs_tpu.core import shapes as J
    from groan_rs_tpu.core.dimension import Dimension as JD
    from groan_rs_tpu_torch.core import shapes as T
    from groan_rs_tpu_torch.core.dimension import Dimension as TD

    return [(T.Sphere([1.0, 1.0, 1.0], 1.2), J.Sphere([1.0, 1.0, 1.0], 1.2)),
            (T.Rectangular([0.5, 0.2, 0.0], 1.0, 2.0, 3.0),
             J.Rectangular([0.5, 0.2, 0.0], 1.0, 2.0, 3.0)),
            (T.Cylinder([1.0, 1.0, 0.0], 1.0, 2.0, TD.Z), J.Cylinder([1.0, 1.0, 0.0], 1.0, 2.0, JD.Z))]


@pytest.mark.parametrize("k", range(3))
@pytest.mark.parametrize("whole_res", [False, True])
def test_select_shape(pairs, k, whole_res):
    xtc, js, ts = pairs["ortho"]
    tshape, jshape = _shapes()[k]
    got = tm.select_dynamic(ts, xtc, "Water", shape=tshape, whole_res=whole_res)
    _same(got, jm.select_dynamic(js, xtc, "Water", shape=jshape, whole_res=whole_res))


def test_select_exact_membership(tmp_path):
    f0 = np.array([[5.0, 5.0, 5.0], [5.2, 5.0, 5.0], [5.0, 5.4, 5.0], [5.0, 5.0, 5.6],
                   [9.95, 5.0, 5.0]])
    f1 = f0.copy()
    f1[3] = [5.0, 5.0, 5.3]
    f1[0] = [0.05, 5.0, 5.0]                    # the reference crosses the box
    xtc, js, ts = frames_pair(tmp_path / "s.xtc", np.stack([f0, f1]), np.full(3, 10.0),
                              {"Ref": [0], "Cand": [1, 2, 3, 4]}, precision=10000,
                              resnum=[1, 2, 2, 3, 4], resname=["R"] * 5)
    got = tm.select_dynamic(ts, xtc, "Cand", within=0.5, of="Ref")
    _same(got, jm.select_dynamic(js, xtc, "Cand", within=0.5, of="Ref"))
    assert got["masks"].tolist() == [[True, True, False, False], [False, False, False, True]]
    res = tm.select_dynamic(ts, xtc, "Cand", within=0.5, of="Ref", whole_res=True)
    assert res["masks"][0].tolist() == [True, True, False, False]
    assert res["masks"][1].tolist() == [False, False, False, True]


# ------------------------------------------------------------------ trjorder

def _orders_agree(got, want):
    """Orders equal wherever JAX's neighbouring distances differ by more
    than ORDER_BOUND; each order sorts its own distances."""
    for f in range(want["dist"].shape[0]):
        assert (np.diff(got["dist"][f][got["order"][f]]) >= 0).all()
        dw = want["dist"][f]
        differ = got["order"][f] != want["order"][f]
        gap = np.abs(dw[got["order"][f]] - dw[want["order"][f]])
        assert (gap[differ] <= ORDER_BOUND).all(), f"frame {f}: {gap[differ].max()}"


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mode,da,chunk", [("atom", 0, 512), ("atom", 2, 100),
                                           ("min", 0, 64), ("com", 0, 512)])
def test_trjorder(pairs, form, mode, da, chunk):
    xtc, js, ts = pairs[form]
    got = tm.trjorder(ts, xtc, "Protein", "WW", mode=mode, da=da, shell=0.5, chunk=chunk)
    want = jm.trjorder(js, xtc, "Protein", "WW", mode=mode, da=da, shell=0.5)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["dist"], want["dist"], rtol=0, atol=1e-5)
    assert np.array_equal(got["molecules"], want["molecules"])
    _orders_agree(got, want)
    near = np.abs(want["dist"] - 0.5) <= ORDER_BOUND
    assert np.array_equal(got["nshell"], want["nshell"]) or near.any()


def test_trjorder_tie_bound_is_needed(pairs):
    """The bound excuses only what float32 rounding explains: on this
    layout each order agrees with JAX's outright or within the bound."""
    xtc, js, ts = pairs["ortho"]
    got = tm.trjorder(ts, xtc, "Protein", "WW", mode="min")
    want = jm.trjorder(js, xtc, "Protein", "WW", mode="min")
    gaps = np.abs(np.diff(np.sort(want["dist"], axis=1), axis=1))
    assert gaps.min() < 1e-3                      # close pairs exist to order
    _orders_agree(got, want)


def test_trjorder_constructed(tmp_path):
    ref = [5.0, 5.0, 5.0]
    f0 = np.array([ref, [5.3, 5.0, 5.0], [5.3, 5.1, 5.0], [5.1, 5.0, 5.0], [5.1, 5.2, 5.0],
                   [5.0, 5.2, 5.0], [5.0, 5.3, 5.0]])
    f1 = f0.copy()
    f1[1:3] += [-0.25, 0.0, 0.0]
    f1[3:5] += [0.4, 0.0, 0.0]
    xtc, js, ts = frames_pair(tmp_path / "o.xtc", np.stack([f0, f1]), np.full(3, 10.0),
                              {"Ref": [0], "Sol": [1, 2, 3, 4, 5, 6]},
                              resnum=[1, 2, 2, 3, 3, 4, 4], resname=["R"] * 7)
    got = tm.trjorder(ts, xtc, "Ref", "Sol", mode="atom")
    want = jm.trjorder(js, xtc, "Ref", "Sol", mode="atom")
    np.testing.assert_allclose(got["dist"], want["dist"], atol=1e-6)
    np.testing.assert_allclose(got["dist"][0], [0.3, 0.1, 0.2], atol=2e-4)
    np.testing.assert_allclose(got["dist"][1], [0.05, 0.5, 0.2], atol=2e-4)
    assert np.array_equal(got["order"], want["order"])


def test_trjorder_output_bytes(pairs, tmp_path):
    xtc, js, ts = pairs["ortho"]
    a, b = str(tmp_path / "t.xtc"), str(tmp_path / "j.xtc")
    got = tm.trjorder(ts, xtc, "Protein", "WW", mode="atom", output=a)
    want = jm.trjorder(js, xtc, "Protein", "WW", mode="atom", output=b)
    assert got["written"] == a and np.array_equal(got["order"], want["order"])
    assert open(a, "rb").read() == open(b, "rb").read()
    grp = str(tmp_path / "g.gro")
    tm.trjorder(ts, xtc, "Protein", "WW", mode="atom", output=grp, out_group="WW")
    jm.trjorder(js, xtc, "Protein", "WW", mode="atom", output=str(tmp_path / "jg.gro"),
                out_group="WW")
    assert open(grp, "rb").read() == open(str(tmp_path / "jg.gro"), "rb").read()


ERRORS = [
    ("select criteria", lambda m, s, x: m.select_dynamic(s, x, "Water")),
    ("select of", lambda m, s, x: m.select_dynamic(s, x, "Water", within=0.3)),
    ("select empty", lambda m, s, x: m.select_dynamic(s, x, "name NOSUCH", within=0.3,
                                                      of="Protein")),
    ("select ref empty", lambda m, s, x: m.select_dynamic(s, x, "Water", within=0.3,
                                                          of="name NOSUCH")),
    ("trjorder mode", lambda m, s, x: m.trjorder(s, x, "Protein", "WW", mode="max")),
    ("trjorder da", lambda m, s, x: m.trjorder(s, x, "Protein", "WW", da=3)),
    ("trjorder empty", lambda m, s, x: m.trjorder(s, x, "name NOSUCH", "WW")),
    ("trjorder sizes", lambda m, s, x: m.trjorder(s, x, "Peptide", "Water", output="o.xtc")),
]


@pytest.mark.parametrize("name,call", ERRORS, ids=[e[0] for e in ERRORS])
def test_errors(pairs, name, call, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    xtc, js, ts = pairs["ortho"]
    got = raised(lambda: call(tm, ts, xtc))
    assert got is not None and got == raised(lambda: call(jm, js, xtc))


def test_trjorder_output_needs_paths(pairs):
    from groan_rs_tpu_torch.models import TrajectoryAnalysis

    xtc, _, ts = pairs["ortho"]
    dt = TrajectoryAnalysis(ts, device="cpu").runner(group="all").load_device(xtc)
    assert raised(lambda: tm.trjorder(ts, dt, "Protein", "WW", output="x.xtc")) == \
        ("ParallelError", "ParallelError")


# ------------------------------------------------------- self_image_min, pi_mindist

def _oracle(pos, rows):
    pos, rows = np.asarray(pos, np.float64), np.asarray(rows, np.float64)
    d0 = pos[:, None, :] - pos[None, :, :]
    mn = min(float(np.sqrt(((d0 + a * rows[0] + b * rows[1] + c * rows[2]) ** 2).sum(-1)).min())
             for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1) if (a, b, c) != (0, 0, 0))
    return mn, float(np.sqrt((d0 ** 2).sum(-1).max()))


def _both_sim(pos, boxes, **kw):
    t = td.self_image_min(torch.from_numpy(np.asarray(pos, np.float32)),
                          torch.from_numpy(np.asarray(boxes, np.float32)), **kw)
    j = jd.self_image_min(np.asarray(pos, np.float32), np.asarray(boxes, np.float32), **kw)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    return [a.numpy() for a in t]


def test_self_image_constructions():
    mn, mx = _both_sim([[[1.0, 1.5, 2.0]]], [[2.0, 3.0, 4.0]])
    assert mn[0] == pytest.approx(2.0, abs=1e-6) and mx[0] == 0.0
    mn, mx = _both_sim([[[0.2, 1.0, 1.0], [4.8, 1.0, 1.0]]], [[5.0, 7.0, 7.0]])
    assert mn[0] == pytest.approx(0.4, abs=1e-6) and mx[0] == pytest.approx(4.6, abs=1e-6)
    rows = np.array([[[2.0, 0.0, 0.0], [1.0, 2.0, 0.0], [0.0, 0.0, 3.0]]])
    mn, _ = _both_sim([[[0.3, 0.4, 0.5]]], rows)
    assert mn[0] == pytest.approx(2.0, rel=1e-6)


@pytest.mark.parametrize("triclinic", [False, True])
@pytest.mark.parametrize("seed", [13, 17])
def test_self_image_oracle_and_chunks(triclinic, seed):
    rng = np.random.default_rng(seed)
    f, k = 4, 37
    if triclinic:
        rows = np.zeros((f, 3, 3))
        rows[:, [0, 1, 2], [0, 1, 2]] = rng.uniform(3.0, 5.0, (f, 3))
        rows[:, [1, 2, 2], [0, 0, 1]] = rng.uniform(-1.0, 1.0, (f, 3))
        boxes = rows.astype(np.float32)
        pos = rng.uniform(0.0, 3.0, size=(f, k, 3))
    else:
        boxes = rng.uniform(3.0, 5.0, size=(f, 3)).astype(np.float32)
        rows = np.stack([np.diag(b) for b in boxes])
        pos = rng.uniform(0.0, 1.0, size=(f, k, 3)) * boxes[:, None, :]
    mn, mx = _both_sim(pos, boxes, chunk=16)
    for chunk in (1, 5, 64):
        a, b = td.self_image_min(torch.from_numpy(pos.astype(np.float32)),
                                 torch.from_numpy(boxes), chunk=chunk)
        assert np.array_equal(a.numpy(), mn) and np.array_equal(b.numpy(), mx)
    for fr in range(f):
        omn, omx = _oracle(pos.astype(np.float32)[fr], rows[fr].astype(np.float32))
        assert mn[fr] == pytest.approx(omn, rel=2e-5, abs=1e-5)
        assert mx[fr] == pytest.approx(omx, rel=2e-5, abs=1e-5)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("group,kw", [("Peptide", {}), ("CA", {"chunk": 7}),
                                      ("Protein", {"start_time": 1.0, "step": 2})])
def test_pi_mindist(pairs, form, group, kw):
    xtc, js, ts = pairs[form]
    got, want = tm.pi_mindist(ts, xtc, group, **kw), jm.pi_mindist(js, xtc, group, **kw)
    _same({k: got[k] for k in ("indices", "times")}, {k: want[k] for k in ("indices", "times")})
    for k in ("min_image", "max_internal"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


def test_pi_mindist_resident(pairs):
    from groan_rs_tpu_torch.models import TrajectoryAnalysis

    xtc, _, ts = pairs["triclinic"]
    dt = TrajectoryAnalysis(ts, device="cpu", triclinic=True).runner(
        group="Peptide").load_device(xtc)
    _same(tm.pi_mindist(ts, dt, "Peptide"), tm.pi_mindist(ts, xtc, "Peptide"))
    assert raised(lambda: tm.pi_mindist(ts, dt, "Peptide", step=2)) == \
        ("ParallelError", "ParallelError")


@pytest.mark.parametrize("triclinic", [False, True])
def test_host_oracles(triclinic):
    """`testing.host_self_image` and `host_nearest` (the phase-16 oracles)
    against brute force."""
    from groan_rs_tpu_torch import testing

    rng = np.random.default_rng(4)
    rows = (np.array([[3.0, 0, 0], [0, 3.0, 0], [1.5, 1.5, 2.1213]]) if triclinic
            else np.diag([3.0, 3.2, 3.4]))
    pos = rng.uniform(0, 2.5, (60, 3))
    mn, mx = _oracle(pos, rows)
    got = testing.host_self_image(pos, rows)
    assert got == pytest.approx((mn, mx), rel=1e-12)
    box = rows if triclinic else np.diag(rows)
    a, b = rng.uniform(0, 3, (30, 3)), rng.uniform(0, 3, (40, 3))
    d = a[:, None] - b[None]
    brute = np.sqrt((testing._mi(d, box) ** 2).sum(-1)).min(1)
    np.testing.assert_allclose(testing.host_nearest(a, b, box), brute, atol=1e-12)


def test_mi_f32_image_takes_the_ports_image():
    """`testing.mi_f32_image` picks the image of the port's float32
    `pbc.min_image` on the 0.001 nm grid at half a 21 nm box, where
    float64 rounding alone picks the other one."""
    from groan_rs_tpu_torch import testing
    from groan_rs_tpu_torch.ops import pbc

    k = np.arange(0, 21000)
    x1 = (np.float32(0.001) * k.astype(np.float32)).astype(np.float32)
    x2 = np.roll(x1, 10500)
    box = np.float32(21.0)
    d64 = x1.astype(np.float64) - x2.astype(np.float64)
    got = testing.mi_f32_image(d64[:, None], np.array([21.0]))[:, 0]
    port = pbc.min_image(torch.from_numpy((x1 - x2)[:, None]), torch.tensor([box])).numpy()[:, 0]
    assert (np.sign(got) == np.sign(port)).all()
    np.testing.assert_allclose(got, port, atol=2e-6)
    plain = d64 - 21.0 * np.round(d64 / 21.0)
    assert (np.sign(plain) != np.sign(port)).any()     # where float64 alone disagrees
