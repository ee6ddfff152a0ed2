"""The interfacial-water analyses of the PyTorch port's `models/membrane.py`
(`_water_sites`, sorient, h2order, spol, hydorder) against groan_rs_tpu's
on the same input, on the CPU: the named 3,000-atom synthetic layout (566
whole waters and a last residue of one oxygen and one hydrogen), 12 frames
in the 21 nm cube and in the rhombic dodecahedron, and the JAX package's
constructed waters and point sets (`test_water_orientation.py`,
`test_saltbr_spol.py`, `test_trjorder_hydorder.py`), each through both
packages; and the float64 oracles of `testing.py`.

Tolerances: histogram counts exact, but for values the oracle finds within
1e-5 (nm, or in cosine) of a bin edge, of which each may move one count;
means within 1e-5 of the JAX package's and of the oracle's (per-shell
means within 1e-4 of the oracle's); hydorder's S_g and S_k within 1e-5 of
the JAX package's and within 1e-4 of a periodic cKDTree query in float64,
on atoms whose 4th and 5th neighbours are not tied within 1e-5 nm.  On exact ties both packages
keep the lower index (`jax.lax.top_k`'s rule), pinned by a constructed
tie.  A DeviceTrajectory gives the file call's bits, and the tiles and
frame chunks change no bit.  Errors raise the JAX package's class, code
and message."""

import numpy as np
import pytest

from groan_rs_tpu import models as J
from groan_rs_tpu.models import membrane as JM

from _torch_parity import frames_pair, raised, synthetic_pair
from groan_rs_tpu_torch import models as T
from groan_rs_tpu_torch import testing
from groan_rs_tpu_torch.io import native
from groan_rs_tpu_torch.models import membrane as TM
from groan_rs_tpu_torch.models import pipeline as TP

N_ATOMS, N_FRAMES = 3000, 12
FORMS = ("ortho", "triclinic")
WW = dict(oxygen="WW and name OW", hydrogens="WW and name HW1 HW2")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """{form: (xtc, jax System, port System, coords [F, N, 3], boxes)} with
    the group WW (the whole waters)."""
    lay = testing.synthetic_layout(N_ATOMS)
    whole = 3 * ((N_ATOMS - lay["w0"]) // 3)
    out = {}
    for form in FORMS:
        path = tmp_path_factory.mktemp(form) / "wat.xtc"
        xtc, js, ts = synthetic_pair(path, n_frames=N_FRAMES, named=True,
                                     triclinic=form == "triclinic")
        for s in (js, ts):
            s.group_create_from_indices("WW", np.arange(lay["w0"], lay["w0"] + whole))
        offs, _, _, nat = native.xtc_scan(xtc)
        coords, b9 = native.xtc_read_frames(xtc, offs, nat)[:2]
        boxes = b9.reshape(-1, 3, 3) if form == "triclinic" else b9[:, [0, 4, 8]]
        out[form] = (xtc, js, ts, coords, boxes.astype(np.float64))
    return out


def _sites(ts):
    o, h = TM._water_sites(ts, WW["oxygen"], WW["hydrogens"])
    return o, h


def _within(got, sure, slack, what):
    bad = np.abs(np.asarray(got, np.float64) - sure) > slack + 1e-9
    assert not bad.any(), (what, np.flatnonzero(bad))


# ------------------------------------------------------------- water sites

def test_water_sites(data):
    xtc, js, ts = data["ortho"][:3]
    a = JM._water_sites(js, WW["oxygen"], WW["hydrogens"])
    b = TM._water_sites(ts, WW["oxygen"], WW["hydrogens"])
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert b[1].shape == (566, 2) and (b[1] == b[0][:, None] + [1, 2]).all()
    # the layout's last residue holds OW and HW1 only
    for args in (("name OW", "name HW1 HW2"), ("name OW", "name HW1"),
                 ("WW and name OW", "name HW2"), ("name CA", "name HW1 HW2"),
                 ("name NOPE", "name HW1 HW2")):
        with pytest.raises(Exception) as ja:
            JM._water_sites(js, *args)
        with pytest.raises(Exception) as ta:
            TM._water_sites(ts, *args)
        assert type(ta.value).__name__ == type(ja.value).__name__ == "GroupError"
        assert ta.value.code == ja.value.code
        assert str(ta.value) == str(ja.value)


# ----------------------------------------------------------- constructed waters

_BOX6 = np.array([6.0, 6.0, 6.0], np.float32)
_D = 0.09572 * np.cos(np.deg2rad(104.52 / 2.0))
_S = 0.09572 * np.sin(np.deg2rad(104.52 / 2.0))


def _water(o, bisector):
    """test_water_orientation.py:30 — O at `o`, the bisector along `bisector`."""
    b = np.asarray(bisector, np.float64)
    b = b / np.linalg.norm(b)
    p = np.cross(b, [1.0, 0.0, 0.0])
    if np.linalg.norm(p) < 1e-6:
        p = np.cross(b, [0.0, 1.0, 0.0])
    p /= np.linalg.norm(p)
    return np.stack([o, o + _D * b + _S * p, o + _D * b - _S * p])


def _waters(path, waters, extra=(), box=_BOX6, masses=None, charges=None):
    coords = list(extra)
    names = ["REF"] * len(extra)
    resnum = list(range(1, len(extra) + 1))
    for w, (o, b) in enumerate(waters):
        coords.extend(_water(np.asarray(o, np.float64), b))
        names.extend(["OW", "HW1", "HW2"])
        resnum.extend([len(extra) + w + 1] * 3)
    n = len(coords)
    cols = {"atomname": np.asarray(names), "resnum": np.asarray(resnum),
            "resname": np.where(np.asarray(names) == "REF", "REF", "SOL")}
    if masses is not None:
        cols["mass"] = masses
    if charges is not None:
        cols["charge"] = charges
    groups = {"Ref": np.arange(len(extra)), "Sol": np.arange(len(extra), n)}
    return frames_pair(path, np.asarray(coords, np.float32)[None], box, groups, **cols)


def _both(fn):
    return fn(J), fn(T)


def _same(a, b, atol=1e-5):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        assert np.array_equal(np.isnan(x), np.isnan(y)), k
        ok = ~np.isnan(x)
        assert np.abs(x[ok] - y[ok]).max(initial=0.0) <= atol, k


REF = np.array([3.0, 3.0, 3.0])
SORIENT_CASES = {
    # test_water_orientation.py:73 — outward, inward, perpendicular
    "exact": ([(REF + [0.4, 0, 0], [1.0, 0, 0]), (REF + [0, 0.4, 0], [0, -1.0, 0]),
               (REF + [0, 0, 0.4], [1.0, 0, 0])], REF, dict(rmax=0.5, bins=20)),
    # :107 — only the middle water is in the shell
    "shell": ([(REF + [0.2, 0, 0], [1.0, 0, 0]), (REF + [0.45, 0, 0], [1.0, 0, 0]),
               (REF + [1.5, 0, 0], [1.0, 0, 0])], REF, dict(rmin=0.3, rmax=0.6)),
    # :121 — across the periodic boundary
    "pbc": ([(np.array([5.8, 3.0, 3.0]), [-1.0, 0, 0])], np.array([0.1, 3.0, 3.0]),
            dict(rmax=0.5)),
}


@pytest.mark.parametrize("case", sorted(SORIENT_CASES))
def test_sorient_constructed(tmp_path, case):
    waters, ref, kw = SORIENT_CASES[case]
    xtc, js, ts = _waters(tmp_path / "so.xtc", waters, extra=[ref])
    a, b = _both(lambda m: m.sorient(js if m is J else ts, xtc, "Ref", **kw))
    _same(a, b)
    want_n = {"exact": 3.0, "shell": 1.0, "pbc": 1.0}[case]
    assert b["n_selected"] == want_n
    want_c1 = {"exact": 0.0, "shell": 1.0, "pbc": 1.0}[case]
    assert b["mean_cos1"] == pytest.approx(want_c1, abs=1e-3)
    if case == "exact":
        h = b["cos1_hist"] * 0.1 * 3
        assert h[0] == pytest.approx(1.0) and h[10] == pytest.approx(1.0)
        assert h[19] == pytest.approx(1.0)


def test_h2order_constructed(tmp_path):
    """test_water_orientation.py:140 — the lower half points +z, the upper -z."""
    waters = [(np.array([1.0 + i, 2.0, 1.5]), [0, 0, 1.0]) for i in range(4)]
    waters += [(np.array([1.0 + i, 2.0, 4.5]), [0, 0, -1.0]) for i in range(4)]
    xtc, js, ts = _waters(tmp_path / "h2.xtc", waters)
    a, b = _both(lambda m: m.h2order(js if m is J else ts, xtc, bins=6))
    _same(a, b)
    assert b["count"][1] == 4.0 and b["count"][4] == 4.0
    assert b["cos"][1] == pytest.approx(1.0, abs=1e-3)
    assert b["cos"][4] == pytest.approx(-1.0, abs=1e-3)
    np.testing.assert_allclose(b["z"], np.arange(6) + 0.5)


_BOX4 = np.array([4.0, 4.0, 4.0], np.float32)


def _spol_waters(path, ref, waters, frames=None):
    """test_saltbr_spol.py:190 — one reference atom and TIP3P-charged waters."""
    n_w = len(waters) if frames is None else (frames.shape[1] - 1) // 3
    masses = np.asarray([1.0] + [15.999, 1.008, 1.008] * n_w, np.float32)
    charges = np.asarray([0.0] + [-0.834, 0.417, 0.417] * n_w, np.float32)
    if frames is None:
        return _waters(path, waters, extra=[ref], box=_BOX4, masses=masses, charges=charges)
    names = np.asarray(["REF"] + ["OW", "HW1", "HW2"] * n_w)
    resnum = np.concatenate([[1], 2 + np.arange(3 * n_w) // 3])
    return frames_pair(path, frames, _BOX4, {"Ref": [0], "Sol": np.arange(1, 1 + 3 * n_w)},
                       atomname=names, resnum=resnum, mass=masses, charge=charges,
                       resname=np.where(names == "REF", "REF", "SOL"))


def test_spol_constructed(tmp_path):
    """test_saltbr_spol.py:214, :240 and :256 — exact orientations, the
    minimum image, and two random frames against a float64 recomputation
    (`testing.host_spol`)."""
    ref = np.array([2.0, 2.0, 2.0])
    xtc, js, ts = _spol_waters(tmp_path / "a.xtc", ref, [
        (ref + [0.45, 0, 0], [1.0, 0, 0]), (ref + [0, 0.25, 0], [0, -1.0, 0]),
        (ref + [0, 0, 0.85], [0, 0, 1.0])])
    a, b = _both(lambda m: m.spol(js if m is J else ts, xtc, "Ref", "Sol", rmax=0.6, bins=6))
    _same(a, b)
    assert b["counts"][4] == 1.0 and b["counts"][2] == 1.0 and b["n_selected"] == 2.0
    assert b["mean_cos_r"][4] == pytest.approx(1.0, abs=1e-5)

    ref = np.array([0.2, 2.0, 2.0])
    xtc, js, ts = _spol_waters(tmp_path / "b.xtc", ref, [(np.array([3.9, 2.0, 2.0]), [-1.0, 0, 0])])
    a, b = _both(lambda m: m.spol(js if m is J else ts, xtc, "Ref", "Sol", rmax=0.6, bins=6))
    _same(a, b)
    assert b["counts"][3] == 1.0 and b["mean_cos"] == pytest.approx(1.0, abs=1e-5)

    rng = np.random.default_rng(7)
    frames = []
    for _ in range(2):
        r0 = rng.uniform(0.5, 3.5, 3)
        coords = [r0[None]]
        for _ in range(24):
            bis = rng.normal(size=3)
            coords.append(_water(np.mod(r0 + rng.normal(0, 0.4, 3), _BOX4), bis / np.linalg.norm(bis)))
        frames.append(np.concatenate(coords))
    frames = np.asarray(frames, np.float32)
    xtc, js, ts = _spol_waters(tmp_path / "c.xtc", None, None, frames=frames)
    a, b = _both(lambda m: m.spol(js if m is J else ts, xtc, "Ref", "Sol", rmax=0.8, bins=8))
    _same(a, b)
    units = frames[:, 1:].reshape(2, 24, 3, 3)
    m = np.array([15.999, 1.008, 1.008])
    want = testing.host_spol(units, np.tile(m / m.sum(), (24, 1)),
                             np.tile([-0.834, 0.417, 0.417], (24, 1)), frames[:, :1],
                             [1.0], np.tile(_BOX4, (2, 1)), 0.8, 8)
    _within(b["counts"], want["cn"], want["cn_slack"], "spol counts")
    ok = want["cn"] > 0
    assert np.abs(b["mean_cos_r"][ok] - want["cs"][ok] / want["cn"][ok]).max() <= 1e-4


def test_spol_errors(tmp_path, data):
    xtc, js, ts = data["ortho"][:3]
    for s in (js, ts):
        s.group_create_from_indices("Nothing", [])
    for args in (("Protein", "Nothing"), ("Nothing", "WW"), ("Protein", "Missing")):
        want = raised(lambda: J.spol(js, xtc, *args))
        assert want is not None and raised(lambda: T.spol(ts, xtc, *args)) == want
    ref = np.array([2.0, 2.0, 2.0])
    path, js2, ts2 = _spol_waters(tmp_path / "q.xtc", ref, [(ref + [0.3, 0, 0], [1.0, 0, 0])])
    for s in (js2, ts2):
        s.topology.has_charge[:] = False
    want = raised(lambda: J.spol(js2, path, "Ref", "Sol"))
    assert want == ("GroupError", "InvalidCharge")
    assert raised(lambda: T.spol(ts2, path, "Ref", "Sol")) == want


# ------------------------------------------------------ the synthetic layout

def _sorient_oracle(ts, coords, boxes, rmin, rmax, nb):
    o, h = _sites(ts)
    ref = ts.group_indices("Protein")
    return testing.host_sorient(coords[:, o], coords[:, h[:, 0]], coords[:, h[:, 1]],
                                coords[:, ref], ts.topology.mass[ref], boxes,
                                rmin, rmax, nb, delta=1e-5)


@pytest.mark.parametrize("form", FORMS)
def test_sorient(data, form):
    xtc, js, ts, coords, boxes = data[form]
    kw = dict(rmin=0.5, rmax=5.0, bins=20, **WW)
    a = J.sorient(js, xtc, "Protein", **kw)
    b = T.sorient(ts, xtc, "Protein", **kw)
    want = _sorient_oracle(ts, coords, boxes, 0.5, 5.0, 20)
    n = b["n_selected"]
    assert abs(n - want["n"]) <= want["n_slack"] and n > 100
    if want["n_slack"] == 0 and not want["h1_slack"].any():
        assert a["n_selected"] == n
        assert np.array_equal(a["cos1_hist"], b["cos1_hist"])
    dc = 2.0 / 20
    _within(b["cos1_hist"] * n * dc, want["h1"], want["h1_slack"], "cos1")
    _within(b["cos2_hist"] * 2 * n * dc, want["h2"], want["h2_slack"], "cos2")
    for key, s in (("mean_cos1", "s1"), ("mean_cos2", "s2")):
        div = n * (2 if s == "s2" else 1)
        assert abs(b[key] - want[s] / div) <= 1e-5 + want[s + "_slack"] / div
        assert abs(b[key] - a[key]) <= 1e-5
    ok = want["rn"] > 0
    assert np.abs(b["mean_cos1_r"][ok] - want["rs"][ok] / want["rn"][ok]).max() <= 1e-4
    for k in ("cos1_edges", "r_bins"):
        assert np.array_equal(a[k], b[k])


@pytest.mark.parametrize("form", FORMS)
def test_sorient_resident_and_repeat(data, form, monkeypatch):
    """A DeviceTrajectory, a second call and frame chunks of one frame give
    the same bits."""
    xtc, js, ts = data[form][:3]
    kw = dict(rmax=5.0, bins=20, **WW)
    a = T.sorient(ts, xtc, "Protein", **kw)
    dt = TP.TrajectoryAnalysis(ts, device="cpu", triclinic=form == "triclinic") \
        .runner(ship="all").load_device(xtc)
    for again in (T.sorient(ts, dt, "Protein", **kw), T.sorient(ts, xtc, "Protein", **kw)):
        for k in a:
            assert np.array_equal(a[k], again[k], equal_nan=True), k
    monkeypatch.setattr(TM, "_CHUNK_ELEMS", 1)
    c = T.sorient(ts, xtc, "Protein", **kw)
    for k in a:
        assert np.array_equal(a[k], c[k], equal_nan=True), k


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("axis", ["z", "x"])
def test_h2order(data, form, axis):
    xtc, js, ts, coords, boxes = data[form]
    if form == "triclinic" and axis == "x":
        want = raised(lambda: J.h2order(js, xtc, axis="x", **WW))
        assert want == ("ParallelError", "ParallelError")
        assert raised(lambda: T.h2order(ts, xtc, axis="x", **WW)) == want
        return
    a = J.h2order(js, xtc, axis=axis, bins=12, **WW)
    b = T.h2order(ts, xtc, axis=axis, bins=12, **WW)
    assert np.array_equal(a["count"], b["count"]) and np.array_equal(a["z"], b["z"])
    ok = b["count"] > 0
    assert np.abs(a["cos"][ok] - b["cos"][ok]).max() <= 1e-5
    o, h = _sites(ts)
    ax = "xyz".index(axis)
    want = testing.host_h2order(coords[:, o], coords[:, h[:, 0]], coords[:, h[:, 1]],
                                boxes, ax, 12)
    assert np.array_equal(b["count"], want["cn"])
    assert b["count"].sum() == N_FRAMES * o.size
    assert np.abs(b["cos"][ok] - want["cs"][ok] / want["cn"][ok]).max() <= 1e-5


@pytest.mark.parametrize("form", FORMS)
def test_spol(data, form):
    xtc, js, ts, coords, boxes = data[form]
    a = J.spol(js, xtc, "Protein", "WW", rmax=5.0, bins=20)
    b = T.spol(ts, xtc, "Protein", "WW", rmax=5.0, bins=20)
    o, h = _sites(ts)
    units = coords[:, np.stack([o, h[:, 0], h[:, 1]], 1)]
    g = np.stack([o, h[:, 0], h[:, 1]], 1)
    m = ts.topology.mass[g].astype(np.float64)
    ref = ts.group_indices("Protein")
    want = testing.host_spol(units, m / m.sum(1, keepdims=True), ts.topology.charge[g],
                             coords[:, ref], ts.topology.mass[ref], boxes, 5.0, 20,
                             delta=1e-5)
    _within(b["counts"], want["cn"], want["cn_slack"], "spol counts")
    if not want["cn_slack"].any():
        assert np.array_equal(a["counts"], b["counts"])
    ok = want["cn"] > 0
    assert np.abs(b["mean_cos_r"][ok] - want["cs"][ok] / want["cn"][ok]).max() <= 1e-4
    assert abs(b["mean_cos"] - a["mean_cos"]) <= 1e-5
    assert np.array_equal(a["r_bins"], b["r_bins"])


# ------------------------------------------------------------------ hydorder

@pytest.mark.parametrize("form", FORMS)
def test_hydorder(data, form):
    xtc, js, ts, coords, boxes = data[form]
    sel = "WW and name OW"
    a = J.hydorder(js, xtc, sel, slabs=6)
    b = T.hydorder(ts, xtc, sel, slabs=6)
    assert b["sg"].shape == (N_FRAMES, 566) and b["sg"].dtype == np.float64
    assert np.array_equal(a["slab_counts"], b["slab_counts"])
    for k in ("sg", "sk", "mean_sg", "mean_sk", "slab_sg", "slab_sk"):
        assert np.abs(a[k] - b[k]).max() <= 1e-5, k
    if form == "ortho":
        o = _sites(ts)[0]
        for f in range(N_FRAMES):
            sg, sk, tied = testing.host_hydorder(coords[f, o], boxes[f])
            assert tied.sum() < 5
            assert np.abs(b["sg"][f][~tied] - sg[~tied]).max() <= 1e-5
            assert np.abs(b["sk"][f][~tied] - sk[~tied]).max() <= 1e-5


@pytest.mark.parametrize("form", FORMS)
def test_hydorder_tiles(data, form, monkeypatch):
    """test_trjorder_hydorder.py:275 — the row chunk, the element budget of
    a tile and a DeviceTrajectory change no bit."""
    xtc, js, ts = data[form][:3]
    sel = "WW and name OW"
    a = T.hydorder(ts, xtc, sel, chunk=7)
    dt = TP.TrajectoryAnalysis(ts, device="cpu", triclinic=form == "triclinic") \
        .runner(ship="all").load_device(xtc)
    outs = [T.hydorder(ts, xtc, sel, chunk=64), T.hydorder(ts, dt, sel)]
    monkeypatch.setattr(TM, "_CHUNK_ELEMS", 3 * 566 * 5)
    outs.append(T.hydorder(ts, xtc, sel, chunk=256))
    for b in outs:
        for k in a:
            assert np.array_equal(a[k], b[k]), k


_TET = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], np.float64) / np.sqrt(3.0)
_SQ = np.array([[0.3, 0, 0], [-0.3, 0, 0], [0, 0.3, 0], [0, -0.3, 0]])
C0 = np.array([2.0, 2.0, 2.0])
HYD_CASES = {
    # test_trjorder_hydorder.py:211-265: centre (sg, sk)
    "tetrahedron": (np.concatenate([[C0], C0 + 0.28 * _TET]), (1.0, 1.0)),
    "square": (np.concatenate([[C0], C0 + _SQ]), (0.5, 1.0)),
    "radii": (np.concatenate([[C0], C0 + np.array([0.2, 0.2, 0.3, 0.3])[:, None] * _TET]),
              (1.0, 1.0 - 0.01 / 0.75)),
    "wrapped": (np.mod(np.concatenate([[[0.05, 0.05, 3.98]], [0.05, 0.05, 3.98] + 0.28 * _TET]),
                       4.0), (1.0, 1.0)),
}


def _points(path, pts):
    pts = np.asarray(pts, np.float32)
    return frames_pair(path, pts[None] if pts.ndim == 2 else pts, _BOX4,
                       {"O": np.arange(pts.shape[-2])})


@pytest.mark.parametrize("case", sorted(HYD_CASES))
def test_hydorder_constructed(tmp_path, case):
    pts, (sg, sk) = HYD_CASES[case]
    xtc, js, ts = _points(tmp_path / "h.xtc", pts)
    a, b = _both(lambda m: m.hydorder(js if m is J else ts, xtc, "O"))
    assert b["sg"][0, 0] == pytest.approx(sg, abs=1e-4)
    assert b["sk"][0, 0] == pytest.approx(sk, abs=1e-4)
    for k in a:
        assert np.abs(a[k] - b[k]).max() <= 1e-5


def test_hydorder_slabs_and_oracle(tmp_path):
    """test_trjorder_hydorder.py:275 and :298 — random points against the
    float64 neighbours (within 1e-4, as phase 15 of `chip_smoke.py` holds
    the card; the JAX test allows 5e-4), and two structures in two slabs."""
    frames = np.random.default_rng(3).uniform(0, 4.0, (2, 40, 3))
    xtc, js, ts = _points(tmp_path / "r.xtc", frames)
    a, b = _both(lambda m: m.hydorder(js if m is J else ts, xtc, "O", chunk=7))
    offs, _, _, nat = native.xtc_scan(xtc)
    q = native.xtc_read_frames(xtc, offs, nat)[0]
    for f in range(2):
        sg, sk, tied = testing.host_hydorder(q[f], _BOX4)
        assert not tied.any()
        for got in (a, b):
            assert np.abs(got["sg"][f] - sg).max() <= 1e-4
            assert np.abs(got["sk"][f] - sk).max() <= 1e-4
        assert np.abs(b["sg"][f] - a["sg"][f]).max() <= 1e-5
    c2 = np.array([3.0, 3.0, 3.0])
    pts = np.concatenate([[[1.0, 1.0, 1.0]], [1.0, 1.0, 1.0] + 0.28 * _TET, [c2], c2 + _SQ])
    xtc, js, ts = _points(tmp_path / "s.xtc", pts)
    a, b = _both(lambda m: m.hydorder(js if m is J else ts, xtc, "O", slabs=2))
    assert b["slab_counts"].tolist() == [5, 5] == a["slab_counts"].tolist()
    assert b["sg"][0, 5] == pytest.approx(0.5, abs=1e-4)
    for k in ("slab_sg", "slab_sk", "sg", "sk"):
        assert np.abs(a[k] - b[k]).max() <= 1e-5


# neighbours of the centre (index 0) at +-0.25 nm along each axis: six equal
# distances, exact in float32 and on the file's 0.001 nm grid
_AXES6 = {"+x": [0.25, 0, 0], "-x": [-0.25, 0, 0], "+y": [0, 0.25, 0],
          "-y": [0, -0.25, 0], "+z": [0, 0, 0.25], "-z": [0, 0, -0.25]}


@pytest.mark.parametrize("order,sg", [
    # lowest four a square (the highest four would hold one opposite pair)
    (("+x", "+y", "-x", "-y", "+z", "-z"), 0.5),
    # lowest four one opposite pair and two more (the highest: a square)
    (("+x", "-x", "+y", "+z", "-y", "-z"), 0.625),
])
def test_hydorder_tie_rule(tmp_path, order, sg):
    """Exact ties of d^2: the centre's four nearest are the four lowest
    indices of its six equidistant neighbours, as `jax.lax.top_k` keeps
    them, so S_g follows the atom order.  Every atom here has ties; both
    packages give the same values."""
    pts = np.concatenate([[C0], C0 + np.array([_AXES6[k] for k in order])])
    xtc, js, ts = frames_pair(tmp_path / "t.xtc", pts[None], _BOX4, {"O": np.arange(7)},
                              precision=1000)
    a, b = _both(lambda m: m.hydorder(js if m is J else ts, xtc, "O"))
    assert b["sg"][0, 0] == sg and a["sg"][0, 0] == pytest.approx(sg, abs=1e-7)
    assert np.abs(a["sg"] - b["sg"]).max() <= 1e-6
    assert np.abs(a["sk"] - b["sk"]).max() <= 1e-6


def test_hydorder_errors(data, tmp_path):
    xtc, js, ts = _points(tmp_path / "e.xtc", np.random.default_rng(0).uniform(0, 4, (4, 3)))
    want = raised(lambda: J.hydorder(js, xtc, "O"))
    assert want == ("GroupError", "EmptyGroup")
    assert raised(lambda: T.hydorder(ts, xtc, "O")) == want
    xtc, js, ts = data["triclinic"][:3]
    want = raised(lambda: J.hydorder(js, xtc, "WW and name OW", axis="x", slabs=3))
    assert want == ("ParallelError", "ParallelError")
    assert raised(lambda: T.hydorder(ts, xtc, "WW and name OW", axis="x", slabs=3)) == want
