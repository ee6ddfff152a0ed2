"""The membrane analyses of the PyTorch port's `models/membrane.py`
(leaflets, potential_profile, order_parameters, densmap, densorder)
against groan_rs_tpu's on the same input, on the CPU: the named 3,000-atom
synthetic layout with the full topology, 12 frames in the 21 nm cube and
in the rhombic dodecahedron, and the JAX package's own constructed inputs
(`test_leaflets.py`, `test_potential.py`, `test_densmap_vanhove.py`,
`test_dipole_densorder.py`, `test_triclinic_models.py`), each through both
packages.  Every result is also held against the float64 oracles of
`testing.py`.

Tolerances: leaflet signs equal (but heads within 1e-5 nm of the centre,
of which there are none here), thickness and centre within 1e-5 nm;
histogram counts exact (float32 tile rule, or the oracle's slack for
atoms within 1e-5 nm of a triclinic tile edge); profiles, maps, fields,
potentials and order parameters within 1e-5 relative to their largest
magnitude; interface positions within 1e-5 nm.  Errors raise the JAX
package's class and code."""

import numpy as np
import pytest
import torch

from groan_rs_tpu import models as J

from _torch_parity import frames_pair, raised, synthetic_pair
from groan_rs_tpu_torch import models as T
from groan_rs_tpu_torch import testing
from groan_rs_tpu_torch.io import native
from groan_rs_tpu_torch.models import membrane as TM
from groan_rs_tpu_torch.models import pipeline as TP

N_ATOMS, N_FRAMES = 3000, 12
FORMS = ("ortho", "triclinic")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """{form: (xtc, jax System, port System, coords [F, N, 3], boxes)}; the
    groups Heads (atom 3 of every lipid, `named_layout`'s P) and WW (the
    whole waters)."""
    lay = testing.synthetic_layout(N_ATOMS)
    whole = 3 * ((N_ATOMS - lay["w0"]) // 3)
    out = {}
    for form in FORMS:
        path = tmp_path_factory.mktemp(form) / "mem.xtc"
        xtc, js, ts = synthetic_pair(path, n_frames=N_FRAMES, named=True,
                                     triclinic=form == "triclinic")
        for s in (js, ts):
            s.group_create_from_indices("Heads", np.arange(lay["n_prot"] + 3, lay["w0"], 50))
            s.group_create_from_indices("WW", np.arange(lay["w0"], lay["w0"] + whole))
            s.group_create_from_indices("Empty", [])
        offs, _, _, nat = native.xtc_scan(xtc)
        coords, b9 = native.xtc_read_frames(xtc, offs, nat)[:2]
        boxes = b9.reshape(-1, 3, 3) if form == "triclinic" else b9[:, [0, 4, 8]]
        out[form] = (xtc, js, ts, coords, boxes.astype(np.float64))
    return out


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.abs(got[ok] - want[ok]).max(initial=0.0) <= rel * max(np.abs(want[ok]).max(initial=0.0), 1e-30)


# ----------------------------------------------------------------- leaflets

@pytest.mark.parametrize("form", FORMS)
def test_leaflets(data, form):
    xtc, js, ts, coords, boxes = data[form]
    a = J.leaflets(js, xtc, "Heads")
    b = T.leaflets(ts, xtc, "Heads")
    assert np.array_equal(a["indices"], b["indices"])
    assert b["leaflet"].dtype == np.int32 and b["thickness"].dtype == np.float32
    lz = boxes[:, 2, 2] if form == "triclinic" else boxes[:, 2]
    leaf, thick, center, near = testing.host_leaflets(coords[:, b["indices"], 2], lz)
    assert not near.any()
    assert np.array_equal(b["leaflet"], a["leaflet"])
    assert np.array_equal(b["leaflet"], leaf)
    for got, want in ((b["thickness"], a["thickness"]), (b["center"], a["center"]),
                      (b["thickness"], thick), (b["center"], center)):
        assert np.abs(np.asarray(got, np.float64) - want).max() <= 1e-5


def _bilayer(path, z_mid, thickness, n_per_leaf=24, seed=5):
    """test_leaflets.py:28 — one frame of two leaflets about z_mid."""
    box = np.array([8.0, 8.0, 10.0], np.float32)
    rng = np.random.default_rng(seed)
    k = 2 * n_per_leaf
    xy = rng.uniform(0, 1, size=(k, 2)) * box[:2]
    z_up = z_mid + thickness / 2 + rng.normal(size=n_per_leaf) * 0.1
    z_dn = z_mid - thickness / 2 + rng.normal(size=n_per_leaf) * 0.1
    z = np.concatenate([z_up, z_dn]) % box[2]
    pts = np.column_stack([xy, z]).astype(np.float32)
    return frames_pair(path, pts[None], box, {"Heads": np.arange(k)},
                       precision=10000), z_up, z_dn


@pytest.mark.parametrize("z_mid", [5.0, 9.7])
def test_leaflets_bilayer(tmp_path, z_mid):
    """test_leaflets.py:52 — a bilayer, and one wrapped across the z face,
    classify exactly in both packages."""
    (xtc, js, ts), z_up, z_dn = _bilayer(tmp_path / "bi.xtc", z_mid, 4.0)
    a = J.leaflets(js, xtc, "Heads")
    b = T.leaflets(ts, xtc, "Heads")
    n = len(z_up)
    assert (b["leaflet"][0, :n] == 1).all() and (b["leaflet"][0, n:] == -1).all()
    assert np.array_equal(a["leaflet"], b["leaflet"])
    np.testing.assert_allclose(b["thickness"][0], z_up.mean() - z_dn.mean(), rtol=5e-3)
    assert abs(float(a["thickness"][0]) - float(b["thickness"][0])) <= 1e-5
    assert abs(float(a["center"][0]) - float(b["center"][0])) <= 1e-5


def test_leaflets_errors(data, tmp_path):
    """test_leaflets.py:87 and test_triclinic_models.py:156."""
    xtc, js, ts = data["ortho"][:3]
    txtc, tjs, tts = data["triclinic"][:3]
    for fn in (lambda m, s, x: m.leaflets(s, x, "Heads", axis="w"),
               lambda m, s, x: m.leaflets(s, x, "Empty"),
               lambda m, s, x: m.leaflets(s, x, "Missing"),
               lambda m, s, x: m.leaflets(s, x, "serial 1")):
        want = raised(lambda: fn(J, js, xtc))
        assert want is not None and raised(lambda: fn(T, ts, xtc)) == want
    want = raised(lambda: J.leaflets(tjs, txtc, "Heads", axis="x"))
    assert want == ("ParallelError", "ParallelError")
    assert raised(lambda: T.leaflets(tts, txtc, "Heads", axis="x")) == want
    assert raised(lambda: T.leaflets(tts, txtc, "Heads", axis="y")) == want


# ---------------------------------------------------------------- potential

@pytest.mark.parametrize("form", FORMS)
def test_potential_profile(data, form):
    xtc, js, ts, coords, boxes = data[form]
    a = J.potential_profile(js, xtc, "Water", n_bins=40)
    b = T.potential_profile(ts, xtc, "Water", n_bins=40)
    for k in ("centers", "rho", "field", "psi"):
        _close(b[k], a[k])
    if form == "ortho":
        q = ts.topology.charge[ts.group_indices("Water")]
        want = testing.host_potential(coords[:, ts.group_indices("Water")], boxes, q, 2, 40)
        for k in ("rho", "field", "psi"):
            _close(b[k], want[k])


def test_potential_capacitor(tmp_path):
    """test_potential.py:57 — two charged plates: constant field between
    them, none outside, a linear potential ramp."""
    box = np.array([4.0, 4.0, 10.0], np.float32)
    g = np.linspace(0.1, 3.9, 10)
    xy = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    k = xy.shape[0]
    pts = np.concatenate([np.column_stack([xy, np.full(k, 3.0)]),
                          np.column_stack([xy, np.full(k, 7.0)])]).astype(np.float32)
    q = np.concatenate([np.full(k, -1.0), np.full(k, 1.0)]).astype(np.float32)
    xtc, js, ts = frames_pair(tmp_path / "cap.xtc", pts[None], box,
                              {"Atoms": np.arange(2 * k)}, precision=10000, charge=q)
    a = J.potential_profile(js, xtc, "Atoms", n_bins=100)
    b = T.potential_profile(ts, xtc, "Atoms", n_bins=100)
    for key in ("centers", "rho", "field", "psi"):
        _close(b[key], a[key])
    z = b["centers"]
    expect = -TP._E_OVER_EPS0_NM * k / (4.0 * 4.0)
    mid = (z > 3.5) & (z < 6.5)
    np.testing.assert_allclose(b["field"][mid], expect, rtol=1e-4)
    np.testing.assert_allclose(b["field"][(z < 2.5) | (z > 7.5)], 0.0, atol=1e-6)
    np.testing.assert_allclose(np.diff(b["psi"][mid]) / np.diff(z[mid]), -expect, rtol=1e-3)


@pytest.mark.parametrize("form", FORMS)
def test_potential_resident_window(data, form):
    """A DeviceTrajectory gives the file call's profile bit for bit; on a
    triclinic window only axis z has a period (the JAX branch)."""
    xtc, js, ts = data[form][:3]
    dt = TP.TrajectoryAnalysis(ts, device="cpu", triclinic=form == "triclinic") \
        .runner(ship="all").load_device(xtc)
    for axis in ("z", "x"):
        if form == "triclinic" and axis == "x":
            assert raised(lambda: T.potential_profile(ts, dt, "Water", axis="x")) == \
                ("ParallelError", "ParallelError")
            continue
        a = T.potential_profile(ts, xtc, "Water", axis=axis, n_bins=30)
        b = T.potential_profile(ts, dt, "Water", axis=axis, n_bins=30)
        for k in a:
            assert np.array_equal(a[k], b[k])


def test_potential_errors(data):
    xtc, js, ts = data["ortho"][:3]
    for fn in (lambda m, s: m.potential_profile(s, xtc, "Water", axis="w"),
               lambda m, s: m.potential_profile(s, xtc, "Missing")):
        want = raised(lambda: fn(J, js))
        assert want is not None and raised(lambda: fn(T, ts)) == want


# ----------------------------------------------------------- order parameters

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("axis", ["z", "x"])
def test_order_parameters(data, form, axis):
    """test_profile_order_dipole.py:335 — grouping and bounds, and the
    float64 order of every C-H bond."""
    xtc, js, ts, coords, boxes = data[form]
    a = J.order_parameters(js, xtc, "Membrane", axis=axis)
    b = T.order_parameters(ts, xtc, "Membrane", axis=axis)
    assert np.array_equal(a["heavy"], b["heavy"])
    assert all(np.array_equal(x, y) for x, y in zip(a["pairs"], b["pairs"]))
    _close(b["s_pairs"], a["s_pairs"])
    _close(b["s"], a["s"])
    c_idx, h_idx = b["pairs"]
    sel = c_idx == b["heavy"][0]
    np.testing.assert_allclose(b["s"][0], b["s_pairs"][sel].mean(), rtol=1e-12)
    n = np.eye(3)["xyz".index(axis)]
    want = np.mean([testing.host_order(coords[f, c_idx], coords[f, h_idx], boxes[f], n)
                    for f in range(N_FRAMES)], axis=0)
    _close(b["s_pairs"], want)


# ------------------------------------------------------------------- densmap

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("weights", ["number", "mass", "charge"])
@pytest.mark.parametrize("axes", ["xy", "yz"])
def test_densmap(data, form, weights, axes):
    xtc, js, ts, coords, boxes = data[form]
    bins = (8, 6)
    a = J.densmap(js, xtc, "Water", axes=axes, bins=bins, weights=weights)
    b = T.densmap(ts, xtc, "Water", axes=axes, bins=bins, weights=weights)
    for k in ("x", "y", "mean_box"):
        assert np.array_equal(a[k], b[k])
    g = ts.group_indices("Water")
    w = {"number": np.ones(g.size), "mass": ts.topology.mass[g],
         "charge": ts.topology.charge[g]}[weights].astype(np.float32)
    i1, i2 = "xyz".index(axes[0]), "xyz".index(axes[1])
    counts, dens, c_slack, d_slack = testing.host_densmap(
        coords[:, g], boxes, i1, i2, *bins, w)
    scale = np.abs(counts).max()
    if weights == "number" and not c_slack.any():
        assert np.array_equal(b["counts"], a["counts"])
        assert np.array_equal(b["counts"], counts)
    assert (np.abs(b["counts"] - counts) <= c_slack + 1e-5 * scale).all()
    assert (np.abs(b["density"] - dens) <= d_slack + 1e-5 * np.abs(dens).max()).all()
    if not c_slack.any():
        _close(b["counts"], a["counts"])
        _close(b["density"], a["density"])
    assert np.array_equal(b["map"].values, b["density"])
    assert b["map"].n_tiles_x() == bins[0] and b["map"].n_tiles_y() == bins[1]


def _dm_frames(path, frames, boxes=None, mass=None, charge=None):
    n = frames.shape[1]
    cols = {k: v for k, v in (("mass", mass), ("charge", charge)) if v is not None}
    return frames_pair(path, frames, np.array([4.0, 4.0, 4.0], np.float32),
                       {"Atoms": np.arange(n)}, boxes=boxes, **cols)


def test_densmap_constructed(tmp_path):
    """test_densmap_vanhove.py:70, :87, :106, :125 — exact counts, mass and
    charge weights, per-frame volumes under NPT, and the GridMap with its
    text round trip, through both packages."""
    rng = np.random.default_rng(3)
    frames = rng.uniform(0.05, 3.95, size=(3, 40, 3))
    xtc, js, ts = _dm_frames(tmp_path / "dm.xtc", frames)
    a = J.densmap(js, xtc, "Atoms", axes="xy", bins=(8, 4))
    b = T.densmap(ts, xtc, "Atoms", axes="xy", bins=(8, 4))
    assert np.array_equal(a["counts"], b["counts"]) and b["counts"].sum() == 120
    _close(b["density"], a["density"])
    assert b["density"].sum() * 64.0 / 32 == pytest.approx(40.0)

    frames = rng.uniform(0, 4, size=(2, 12, 3))
    mass, charge = rng.uniform(1, 16, size=12), rng.normal(size=12)
    xtc, js, ts = _dm_frames(tmp_path / "w.xtc", frames, mass=mass, charge=charge)
    for w in ("mass", "charge"):
        a = J.densmap(js, xtc, "Atoms", axes="yz", bins=(5, 5), weights=w)
        b = T.densmap(ts, xtc, "Atoms", axes="yz", bins=(5, 5), weights=w)
        _close(b["counts"], a["counts"])
        _close(b["density"], a["density"])

    frames = np.array([[[1.0, 1.0, 1.0]], [[1.25, 1.25, 1.25]]])
    boxes = np.array([[4.0, 4.0, 4.0], [5.0, 5.0, 5.0]], np.float32)
    xtc, js, ts = _dm_frames(tmp_path / "npt.xtc", frames, boxes=boxes)
    b = T.densmap(ts, xtc, "Atoms", axes="xy", bins=(4, 4))
    assert b["counts"][1, 1] == 2.0 and b["counts"].sum() == 2.0
    assert b["density"][1, 1] == pytest.approx((16 / 64 + 16 / 125) / 2, rel=1e-6)
    np.testing.assert_allclose(b["mean_box"], [4.5, 4.5, 4.5])
    _close(b["density"], J.densmap(js, xtc, "Atoms", axes="xy", bins=(4, 4))["density"])

    frames = np.array([[[0.5, 2.5, 1.0], [0.5, 2.5, 3.0]]])
    xtc, js, ts = _dm_frames(tmp_path / "gm.xtc", frames)
    a = J.densmap(js, xtc, "Atoms", axes="xy", bins=(4, 4))["map"]
    gm = T.densmap(ts, xtc, "Atoms", axes="xy", bins=(4, 4))["map"]
    assert gm.get_at(0.5, 2.5) == pytest.approx(2.0 * 16.0 / 64.0, rel=1e-6)
    assert gm.get_at(2.5, 0.5) == 0.0
    ja, jb = tmp_path / "a.dat", tmp_path / "b.dat"
    a.save(ja)
    gm.save(jb)
    assert ja.read_text() == jb.read_text()
    back = type(gm).from_file(jb)
    assert np.array_equal(back.values, type(a).from_file(ja).values)


@pytest.mark.parametrize("form", FORMS)
def test_densmap_resident_window(data, form):
    """A DeviceTrajectory gives the file call's map bit for bit, and the
    triclinic map keeps every atom (test_triclinic_models.py:376)."""
    xtc, js, ts = data[form][:3]
    dt = TP.TrajectoryAnalysis(ts, device="cpu", triclinic=form == "triclinic") \
        .runner(ship="all").load_device(xtc)
    a = T.densmap(ts, xtc, "Protein", bins=(8, 8), weights="mass")
    b = T.densmap(ts, dt, "Protein", bins=(8, 8), weights="mass")
    for k in ("density", "counts", "x", "y", "mean_box"):
        assert np.array_equal(a[k], b[k])
    n = T.densmap(ts, dt, "Protein", bins=(8, 8))["counts"].sum()
    assert n == N_FRAMES * len(ts.group_indices("Protein"))


def test_densmap_frame_chunks(data, monkeypatch):
    """Frames go through the map in chunks; the chunks change no count."""
    xtc, js, ts = data["ortho"][:3]
    a = T.densmap(ts, xtc, "Water", bins=(8, 6))
    monkeypatch.setattr(TM, "_CHUNK_ELEMS", 3 * 1700 * 5)
    b = T.densmap(ts, xtc, "Water", bins=(8, 6))
    assert np.array_equal(a["counts"], b["counts"])
    _close(b["density"], a["density"], rel=1e-6)


def test_densmap_errors(data):
    xtc, js, ts = data["ortho"][:3]
    for fn in (lambda m, s: m.densmap(s, xtc, "Water", axes="xx"),
               lambda m, s: m.densmap(s, xtc, "Water", axes="x"),
               lambda m, s: m.densmap(s, xtc, "Water", axes="xw"),
               lambda m, s: m.densmap(s, xtc, "Water", weights="volume"),
               lambda m, s: m.densmap(s, xtc, "Empty")):
        want = raised(lambda: fn(J, js))
        assert want is not None and raised(lambda: fn(T, ts)) == want


def test_densmap_float32_counts_stop_at_2_24():
    """A gap of the reference kept on purpose: the JAX function counts
    with float32 ones (`models/membrane.py:267`), and so does the port, so
    one tile's count stops rising at 2^24.  One scatter of 2^24 + 1000
    ones into one tile gives 2^24 in both packages; an integer count would
    give 2^24 + 1000."""
    import jax.numpy as jnp

    n = (1 << 24) + 1000
    flat = np.zeros(n, np.int32)
    a = float(jnp.zeros((4,), jnp.float32).at[flat].add(jnp.ones((n,), jnp.float32))[0])
    out = torch.zeros(4, dtype=torch.float32)
    out.index_put_((torch.zeros(n, dtype=torch.int64),),
                   torch.ones(n, dtype=torch.float32), accumulate=True)
    assert a == float(out[0]) == float(1 << 24)


# ----------------------------------------------------------------- densorder

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mode", ["mass", "number"])
def test_densorder(data, form, mode):
    xtc, js, ts, coords, boxes = data[form]
    a = J.densorder(js, xtc, "Membrane", bins=50, mode=mode)
    b = T.densorder(ts, xtc, "Membrane", bins=50, mode=mode)
    _close(b["profiles"], a["profiles"])
    assert np.array_equal(a["box_len"], b["box_len"])
    for k in ("lower", "upper", "thickness"):
        assert np.abs(b[k] - a[k]).max() <= 1e-5
    for k in ("lower_sigma", "upper_sigma"):
        assert abs(b[k] - a[k]) <= 1e-5
    if form == "ortho":
        g = ts.group_indices("Membrane")
        w = ts.topology.mass[g] if mode == "mass" else np.ones(g.size)
        scale = 1.66053906660 if mode == "mass" else 1.0
        prof = np.stack([testing.host_density_profile(coords[f, g], boxes[f], 2, 50, w, scale)
                         for f in range(N_FRAMES)])
        lower, upper = testing.host_interfaces(prof, boxes[:, 2], 0.5)
        assert np.abs(b["lower"] - lower).max() <= 1e-5
        assert np.abs(b["upper"] - upper).max() <= 1e-5


def _slab(z_lo, z_hi, bins, box_len, per_bin=4):
    """test_dipole_densorder.py:203 — atoms at the occupied slab centres."""
    width = box_len / bins
    zs = (np.arange(int(round(z_lo / width)), int(round(z_hi / width))) + 0.5) * width
    return np.asarray([[0.5 + k, 2.0, z] for z in zs for k in range(per_bin)])


@pytest.mark.parametrize("case", ["exact", "npt", "edge"])
def test_densorder_slabs(tmp_path, case):
    """test_dipole_densorder.py:217, :231, :245 — a flat slab's half-max
    crossings, NPT scaling and a slab touching z = 0."""
    pts = _slab(0.0 if case == "edge" else 1.0, 2.0 if case == "edge" else 3.0, 40, 4.0)
    frames = np.stack([pts, pts * 1.5]) if case == "npt" else pts[None]
    boxes = (np.array([[4.0] * 3, [6.0] * 3], np.float32) if case == "npt" else None)
    xtc, js, ts = _dm_frames(tmp_path / "s.xtc", frames, boxes=boxes)
    a = J.densorder(js, xtc, "Atoms", bins=40, mode="number")
    b = T.densorder(ts, xtc, "Atoms", bins=40, mode="number")
    for k in ("lower", "upper", "thickness", "box_len"):
        assert np.abs(b[k] - a[k]).max() <= 1e-5
    want = {"exact": ([1.0], [3.0]), "npt": ([1.0, 1.5], [3.0, 4.5]),
            "edge": ([0.5 / 40 * 4.0], [2.0])}[case]
    np.testing.assert_allclose(b["lower"], want[0], atol=2e-3)
    np.testing.assert_allclose(b["upper"], want[1], atol=2e-3)


def test_densorder_errors(data):
    xtc, js, ts = data["ortho"][:3]
    for fn in (lambda m, s: m.densorder(s, xtc, "Membrane", axis="w"),
               lambda m, s: m.densorder(s, xtc, "Membrane", mode="volume"),
               lambda m, s: m.densorder(s, xtc, "Empty")):
        want = raised(lambda: fn(J, js))
        assert want is not None and raised(lambda: fn(T, ts)) == want


def test_exports():
    from groan_rs_tpu_torch.models import pipeline

    for name in ("leaflets", "potential_profile", "order_parameters", "densmap",
                 "densorder", "sorient", "h2order", "spol", "hydorder", "_water_sites"):
        assert getattr(pipeline, name) is getattr(TM, name)
        assert name.startswith("_") or getattr(T, name) is getattr(TM, name)
    assert TP._AXIS == {"x": 0, "y": 1, "z": 2} and TP._E_OVER_EPS0_NM == 18.0951262
