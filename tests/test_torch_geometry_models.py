"""The geometric analyses of `models/geometry.py` in the PyTorch port against
the JAX package: `polystat`, `sdf`, `write_cube`, `helixorient`, `bundle`,
`dyecoupl`, `gangle`, `pairdist` and `saltbr`.

Both packages analyse the same XTC: the named 3,000-atom synthetic layout
(`_torch_parity.geometry_pairs`, a cube and a rhombic dodecahedron, 6
frames) and the JAX tests' hand-built geometries (`frames_pair`).
Tolerances, from the JAX package's own tests of the same functions
(`test_polystat.py`, `test_sdf.py`, `test_helixorient.py`,
`test_bundle_dyecoupl_chi.py`, `test_gangle_pairdist.py`): distances and
lengths 1e-5 nm, angles 1e-3 degrees (helix twist 0.05), SDF grids rtol
1e-4 (and voxel counts equal), rise 1e-4 nm.  Port against JAX on the
synthetic layout: values within 1e-5 (2e-5 for the polymer sums over
thousands of bonds); an angle from `arccos` near 0 or 180 degrees carries
float32 rounding of its cosine as sqrt(2 * 6e-8) rad = 0.02 degrees, so
cosines are held within 1e-5 (the positional tolerance) and the angles
within 1e-3 degrees where both lie a degree or more inside (0, 180)."""

import numpy as np
import pytest

from _torch_parity import frames_pair, geometry_pairs, raised
from groan_rs_tpu import models as jm
from groan_rs_tpu_torch import models as tm


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return geometry_pairs(tmp_path_factory)


def _close(got, want, atol, keys=None):
    for k in (keys or want):
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if w.dtype.kind in "fc":
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k, equal_nan=True)
        else:
            assert np.array_equal(g, w), k


def _angles_close(got, want):
    """Degrees: cosines within 1e-5 everywhere, angles within 1e-3 where
    both lie 1 degree or more inside (0, 180)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(np.cos(np.radians(got)), np.cos(np.radians(want)), atol=1e-5)
    inner = (np.minimum(want, 180 - want) > 1.0) & (np.minimum(got, 180 - got) > 1.0)
    np.testing.assert_allclose(got[inner], want[inner], atol=1e-3)


FORMS = ["ortho", "triclinic"]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mass_weighted", [False, True])
def test_polystat(pairs, form, mass_weighted):
    xtc, js, ts = pairs[form]
    got = tm.polystat(ts, xtc, "Membrane", mass_weighted=mass_weighted)
    want = jm.polystat(js, xtc, "Membrane", mass_weighted=mass_weighted)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("fit,weights", [(False, "number"), (True, "mass")])
def test_sdf(pairs, form, fit, weights):
    xtc, js, ts = pairs[form]
    got = tm.sdf(ts, xtc, "WW", "Protein", bins=10, fit=fit, weights=weights)
    want = jm.sdf(js, xtc, "WW", "Protein", bins=10, fit=fit, weights=weights)
    assert np.array_equal(got["counts"], want["counts"])
    np.testing.assert_allclose(got["grid"], want["grid"], rtol=1e-4)
    assert (got["origin"] == want["origin"]).all() and got["voxel"] == want["voxel"]
    assert got["occupancy"] == want["occupancy"]


def _sdf_system(tmp_path, frames, names):
    return frames_pair(tmp_path / "sdf.xtc", frames, np.array([6.0, 6.0, 6.0]),
                       {"Ref": np.flatnonzero(np.asarray(names) == "REF"),
                        "Sat": np.flatnonzero(np.asarray(names) == "SAT")},
                       atomname=names)


def test_sdf_exact_voxels_and_pbc(tmp_path):
    ref = np.array([3.0, 3.0, 3.0])
    pts = np.stack([ref, ref + [0.3, 0, 0], ref + [0, -0.7, 0], ref + [1.5, 0, 0]])
    xtc, js, ts = _sdf_system(tmp_path, pts[None], ["REF", "SAT", "SAT", "SAT"])
    got = tm.sdf(ts, xtc, "Sat", "Ref", side=2.0, bins=8)
    _close(got, jm.sdf(js, xtc, "Sat", "Ref", side=2.0, bins=8), 0.0)
    assert got["counts"].sum() == 2.0 and got["counts"][5, 4, 4] == 1.0
    assert got["counts"][4, 1, 4] == 1.0
    assert got["occupancy"] == pytest.approx(2.0 / 3.0)
    pts = np.array([[5.9, 3.0, 3.0], [0.3, 3.0, 3.0]])
    xtc, js, ts = frames_pair(tmp_path / "pbc.xtc", pts[None], np.array([6.0, 6.0, 6.0]),
                              {"Ref": [0], "Sat": [1]})
    assert tm.sdf(ts, xtc, "Sat", "Ref", side=2.0, bins=8)["counts"][5, 4, 4] == 1.0


def test_sdf_rotational_fit_concentrates(tmp_path):
    centre = np.array([3.0, 3.0, 3.0])
    frames = []
    for k in range(4):
        a = np.pi / 2 * k
        rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
        ref_pts = np.stack([centre + rot @ [0.4, 0.0, 0.0], centre + rot @ [-0.4, 0.0, 0.0],
                            centre + rot @ [0.0, 0.0, 0.4]])
        frames.append(np.vstack([ref_pts, (centre + rot @ [0.13, 0.57, 0.0])[None]]))
    xtc, js, ts = _sdf_system(tmp_path, np.stack(frames), ["REF"] * 3 + ["SAT"])
    plain = tm.sdf(ts, xtc, "Sat", "Ref", side=2.0, bins=10)
    fitted = tm.sdf(ts, xtc, "Sat", "Ref", side=2.0, bins=10, fit=True)
    _close(fitted, jm.sdf(js, xtc, "Sat", "Ref", side=2.0, bins=10, fit=True), 0.0)
    assert (plain["counts"] > 0).sum() == 4
    assert (fitted["counts"] > 0).sum() == 1 and fitted["counts"].max() == 4.0


@pytest.mark.parametrize("shape,comment", [((4, 3, 5), "groan_rs_tpu SDF"),
                                           ((2, 2, 13), "another comment")])
def test_write_cube_bytes(tmp_path, shape, comment):
    grid = np.random.default_rng(61).uniform(0, 5, size=shape)
    a, b = str(tmp_path / "t.cube"), str(tmp_path / "j.cube")
    tm.write_cube(a, grid, np.array([-1.0, -1.5, 0.25]), 0.5, comment=comment)
    jm.write_cube(b, grid, np.array([-1.0, -1.5, 0.25]), 0.5, comment=comment)
    assert open(a, "rb").read() == open(b, "rb").read()
    vals = np.array([float(x) for ln in open(a).read().splitlines()[7:] for x in ln.split()])
    np.testing.assert_allclose(vals.reshape(shape), grid, rtol=1e-4)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("axis", ["z", "x"])
def test_helixorient_synthetic(pairs, form, axis):
    xtc, js, ts = pairs[form]
    got = tm.helixorient(ts, xtc, "CA", axis=axis)
    want = jm.helixorient(js, xtc, "CA", axis=axis)
    _close(got, want, 1e-5, ["axis_vec", "rise", "radius", "rise_per_residue",
                             "local_axes", "resids"])
    for k in ("tilt", "twist", "twist_per_residue"):
        _angles_close(got[k], want[k])


def _ideal_helix(nres, radius=0.23, rise=0.15, twist_deg=100.0, rot=None,
                 offset=(5.0, 5.0, 1.0)):
    t = np.deg2rad(twist_deg) * np.arange(nres)
    ca = np.stack([radius * np.cos(t), radius * np.sin(t), rise * np.arange(nres)], axis=1)
    if rot is not None:
        ca = ca @ np.asarray(rot).T
    return ca + np.asarray(offset)


@pytest.mark.parametrize("case", ["ideal", "tilted", "wrapped"])
def test_helixorient_ideal_helix(tmp_path, case):
    a = np.deg2rad(30.0)
    rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    ca = {"ideal": _ideal_helix(12), "tilted": _ideal_helix(12, rot=rot, offset=(5, 5, 3)),
          "wrapped": _ideal_helix(12, offset=(5.0, 5.0, 9.5)) % 10.0}[case]
    n = ca.shape[0]
    xtc, js, ts = frames_pair(tmp_path / "h.xtc", ca[None], np.array([10.0, 10.0, 10.0]),
                              {"H": np.arange(n)}, atomname=["CA"] * n,
                              resnum=np.arange(1, n + 1), resname=["ALA"] * n)
    got, want = tm.helixorient(ts, xtc, "H"), jm.helixorient(js, xtc, "H")
    _close(got, want, 1e-5, ["axis_vec", "rise", "radius", "rise_per_residue", "resids"])
    for k in ("tilt", "twist", "twist_per_residue"):
        _angles_close(got[k], want[k])
    assert got["tilt"][0] == pytest.approx(30.0 if case == "tilted" else 0.0, abs=0.1)
    assert got["rise"][0] == pytest.approx(0.15, abs=1e-4)
    assert got["twist"][0] == pytest.approx(100.0, abs=0.05)
    assert got["radius"][0] == pytest.approx(0.23, abs=1e-3)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mass_weighted", [True, False])
def test_bundle_synthetic(pairs, form, mass_weighted):
    xtc, js, ts = pairs[form]
    args = ("CA", "Protein and name N")
    got = tm.bundle(ts, xtc, *args, n_axes=3, mass_weighted=mass_weighted)
    want = jm.bundle(js, xtc, *args, n_axes=3, mass_weighted=mass_weighted)
    _close(got, want, 1e-5, ["length", "distance", "zshift", "axes", "center"])
    for k in ("tilt", "tiltr", "tiltl"):
        _angles_close(got[k], want[k])


def _ring_bundle(tilt_out=0.0, tilt_tan=0.0, centre=(5.0, 5.0)):
    pos = []
    for k in range(4):
        ang = np.pi / 2 * k
        r_hat = np.array([np.cos(ang), np.sin(ang), 0.0])
        t_hat = np.array([-np.sin(ang), np.cos(ang), 0.0])
        base = np.array([centre[0], centre[1], 0.0]) + r_hat
        half = 0.5 * (tilt_out * r_hat + tilt_tan * t_hat)
        pos.extend([base + [0, 0, 2.0] - half, base + [0, 0, 5.0] + half])
    return np.asarray(pos)


@pytest.mark.parametrize("kw", [{}, {"tilt_out": 0.5}, {"tilt_tan": 0.5},
                                {"tilt_out": 0.3, "centre": (9.5, 5.0)}])
def test_bundle_ring(tmp_path, kw):
    pos = _ring_bundle(**kw)
    pos[:, 0] %= 10.0
    xtc, js, ts = frames_pair(tmp_path / "b.xtc", pos[None], np.array([10.0, 10.0, 10.0]),
                              {"T": np.arange(1, 8, 2), "B": np.arange(0, 8, 2)})
    bots = [f"serial {2 * k + 1}" for k in range(4)]
    tops = [f"serial {2 * k + 2}" for k in range(4)]
    got, want = tm.bundle(ts, xtc, tops, bots), jm.bundle(js, xtc, tops, bots)
    _close(got, want, 1e-5, ["length", "distance", "zshift", "axes", "center"])
    for k in ("tilt", "tiltr", "tiltl"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-3)
    d = kw.get("tilt_out", kw.get("tilt_tan", 0.0))
    np.testing.assert_allclose(got["length"], np.hypot(d, 3.0), atol=1e-5)
    np.testing.assert_allclose(got["tilt"], np.degrees(np.arcsin(d / np.hypot(d, 3.0))),
                               atol=1e-3)


@pytest.mark.parametrize("geom,k2", [("parallel_perp", 1.0), ("collinear", 4.0),
                                     ("crossed", 0.0), ("pbc", 1.0)])
def test_dyecoupl_canonical(tmp_path, geom, k2):
    d = np.array([[5.0, 5.0, 5.0], [5.0, 5.0, 5.4]])
    a = d + [2.0, 0.0, 0.0]
    if geom == "collinear":
        d = np.array([[4.0, 5.0, 5.0], [4.4, 5.0, 5.0]])
        a = d + [2.0, 0.0, 0.0]
    elif geom == "crossed":
        a = np.array([[7.0, 4.8, 5.2], [7.0, 5.2, 5.2]])
    elif geom == "pbc":
        d = np.array([[9.8, 5.0, 4.8], [9.8, 5.0, 5.2]])
        a = np.array([[0.4, 5.0, 4.8], [0.4, 5.0, 5.2]])
    pos = np.concatenate([d, a])
    xtc, js, ts = frames_pair(tmp_path / "d.xtc", pos[None], np.array([10.0, 10.0, 10.0]),
                              {}, atomname=["D1", "D2", "A1", "A2"])
    got = tm.dyecoupl(ts, xtc, "name D1 D2", "name A1 A2", r0=2.0)
    _close(got, jm.dyecoupl(js, xtc, "name D1 D2", "name A1 A2", r0=2.0), 1e-6)
    np.testing.assert_allclose(got["kappa2"], k2, atol=1e-5)
    np.testing.assert_allclose(got["r"], 0.6 if geom == "pbc" else 2.0, atol=1e-5)


@pytest.mark.parametrize("form", FORMS)
def test_dyecoupl_synthetic(pairs, form):
    xtc, js, ts = pairs[form]
    got = tm.dyecoupl(ts, xtc, "serial 2 6", "serial 101 141", r0=5.0)
    _close(got, jm.dyecoupl(js, xtc, "serial 2 6", "serial 101 141", r0=5.0), 1e-5)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("g1,g2,group2", [
    ("vector", "z", None), ("plane", "t0", None), ("vector", "x", None),
    ("plane", "vector", "serial 1 2"), ("vector", "plane", "WW")])
def test_gangle(pairs, form, g1, g2, group2):
    xtc, js, ts = pairs[form]
    group1 = "WW" if g1 == "plane" else "WW and name OW HW1"
    got = tm.gangle(ts, xtc, group1, g1=g1, g2=g2, group2=group2)
    want = jm.gangle(js, xtc, group1, g1=g1, g2=g2, group2=group2)
    _angles_close(got["angles"], want["angles"])
    np.testing.assert_allclose(got["mean"], want["mean"], atol=1e-3)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("split,mode", [("res", "min"), ("res", "com"), ("atom", "min"),
                                        ("group", "com"), ("atom", "com")])
def test_pairdist(pairs, form, split, mode):
    xtc, js, ts = pairs[form]
    g1, g2 = ("Peptide", "CA") if split == "atom" else ("Protein", "Membrane")
    got = tm.pairdist(ts, xtc, g1, g2, split=split, mode=mode)
    want = jm.pairdist(js, xtc, g1, g2, split=split, mode=mode)
    assert set(got) == set(want)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kw", [{"min_charge": 0.3}, {"min_charge": 0.3, "trunc": 1.5}])
def test_saltbr(pairs, form, kw):
    xtc, js, ts = pairs[form]
    got, want = tm.saltbr(ts, xtc, "Protein", **kw), jm.saltbr(js, xtc, "Protein", **kw)
    assert set(got) == set(want)
    _close(got, want, 1e-5)


ERRORS = [
    ("polystat", lambda m, s, x: m.polystat(s, x, "serial 1")),
    ("sdf weights", lambda m, s, x: m.sdf(s, x, "WW", "Protein", weights="charge")),
    ("sdf empty", lambda m, s, x: m.sdf(s, x, "name NOSUCH", "Protein")),
    ("helixorient axis", lambda m, s, x: m.helixorient(s, x, "CA", axis="w")),
    ("helixorient CA", lambda m, s, x: m.helixorient(s, x, "Water")),
    ("bundle n_axes", lambda m, s, x: m.bundle(s, x, "CA", "CA")),
    ("bundle split", lambda m, s, x: m.bundle(s, x, "CA", "CA", n_axes=7)),
    ("bundle count", lambda m, s, x: m.bundle(s, x, ["CA"], ["serial 1", "serial 3"])),
    ("bundle axis", lambda m, s, x: m.bundle(s, x, "CA", "CA", n_axes=3, axis="q")),
    ("dyecoupl atoms", lambda m, s, x: m.dyecoupl(s, x, "all", "serial 1 2")),
    ("dyecoupl r0", lambda m, s, x: m.dyecoupl(s, x, "serial 1 2", "serial 3 4", r0=-1.0)),
    ("gangle g1", lambda m, s, x: m.gangle(s, x, "WW", g1="line")),
    ("gangle g2", lambda m, s, x: m.gangle(s, x, "WW", g1="plane", g2="w")),
    ("gangle group2", lambda m, s, x: m.gangle(s, x, "WW", g1="plane", g2="vector")),
    ("gangle width", lambda m, s, x: m.gangle(s, x, "Water", g1="plane")),
    ("gangle sites", lambda m, s, x: m.gangle(s, x, "WW", g1="plane", g2="vector",
                                               group2="serial 1 2 3 4")),
    ("pairdist split", lambda m, s, x: m.pairdist(s, x, "CA", "CA", split="mol")),
    ("pairdist mode", lambda m, s, x: m.pairdist(s, x, "CA", "CA", mode="max")),
    ("pairdist empty", lambda m, s, x: m.pairdist(s, x, "CA", "name NOSUCH")),
    ("saltbr charges", lambda m, s, x: m.saltbr(s, x, "Protein", min_charge=50.0)),
]


@pytest.mark.parametrize("name,call", ERRORS, ids=[e[0] for e in ERRORS])
def test_errors(pairs, name, call):
    xtc, js, ts = pairs["ortho"]
    got = raised(lambda: call(tm, ts, xtc))
    assert got is not None and got == raised(lambda: call(jm, js, xtc))


# ------------------------------------------------ chi and the float64 oracles

def test_chi_full_side_chains(tmp_path):
    """`chi` on ideal residues with every chi-site alternative
    (`testing.chi_state`): the port equals JAX within 1e-3 degrees (the
    JAX test's chi tolerance) and the placed angles within 3e-2 (the XTC's
    1e-5 nm grid moves each atom by up to 8.7e-6 nm: 3.5e-3 degrees over a
    0.14 nm lever arm, four atoms a site)."""
    from groan_rs_tpu_torch import testing

    st = testing.chi_state(2, 3)
    xtc, js, ts = frames_pair(tmp_path / "chi.xtc", st["frames"], st["box"], {},
                              atomname=st["atomname"], resname=st["resname"],
                              resnum=st["resnum"])
    got = tm.chi(ts, xtc, "all", max_chi=4)
    want = jm.chi(js, xtc, "all", max_chi=4)
    assert set(got) == set(want)
    for k in range(1, 5):
        nm = f"chi{k}"
        assert np.array_equal(got[f"{nm}_resids"], want[f"{nm}_resids"])
        assert list(got[f"{nm}_resnames"]) == list(want[f"{nm}_resnames"])
        gap = (got[nm] - want[nm] + 180.0) % 360.0 - 180.0
        assert np.abs(gap).max() <= 1e-3, nm
        placed = (got[nm] - st["chi"][k] + 180.0) % 360.0 - 180.0
        assert np.abs(placed).max() <= 3e-2, nm
        q = np.round(st["frames"] * 1e5) / 1e5
        host = testing.dihedrals_host_f64(*(q[:, st["sites"][k][:, i]] for i in range(4)),
                                          np.repeat(st["box"][None], q.shape[0], 0))
        assert np.abs((got[nm] - host + 180.0) % 360.0 - 180.0).max() <= 2e-2, nm
    for w in ("g+", "t", "g-"):
        assert np.array_equal(got["rotamers"][w], want["rotamers"][w])


@pytest.mark.parametrize("form", FORMS)
def test_oracles_agree_with_the_port(pairs, form):
    """The float64 oracles of `chip_smoke.py` phase 16 against the port on
    the synthetic layout (tolerances as above)."""
    from groan_rs_tpu_torch import testing
    from groan_rs_tpu_torch.io import native

    xtc, _, ts = pairs[form]
    offs, _, _, nat = native.xtc_scan(xtc)
    coords, b9 = native.xtc_read_frames(xtc, offs, nat)[:2]
    boxes = b9.reshape(-1, 3, 3) if form == "triclinic" else b9[:, [0, 4, 8]]
    ca = ts.group_indices("CA")
    hx = tm.helixorient(ts, xtc, "CA")
    for f in range(len(coords)):
        want = testing.host_helixorient(coords[f, ca], boxes[f], 2)
        for k in ("axis_vec", "rise", "radius", "rise_per_residue"):
            np.testing.assert_allclose(hx[k][f], want[k], atol=1e-5, err_msg=k)
        for k in ("tilt", "twist", "twist_per_residue"):
            np.testing.assert_allclose(np.cos(np.radians(hx[k][f])),
                                       np.cos(np.radians(want[k])), atol=1e-5, err_msg=k)
    dye = tm.dyecoupl(ts, xtc, "serial 2 6", "serial 101 141")
    for f in range(len(coords)):
        r, k2 = testing.host_dyecoupl(coords[f], [1, 5], [100, 140], boxes[f])
        assert abs(dye["r"][f] - r) <= 1e-5 and abs(dye["kappa2"][f] - k2) <= 1e-5
    ww = ts.group_indices("WW").reshape(-1, 3)
    ga = tm.gangle(ts, xtc, "WW", g1="plane", g2="z")
    for f in range(len(coords)):
        dirs, bound = testing.host_site_dirs(coords[f], ww, boxes[f])
        gap = np.abs(np.cos(np.radians(ga["angles"][f])) - dirs[:, 2])
        assert (gap <= bound + 1e-6).all(), gap.max()
    mem = ts.group_indices("Membrane").reshape(-1, 50)
    ps = tm.polystat(ts, xtc, "Membrane")
    want = testing.host_polystat(coords, mem, np.full(len(mem), 50), np.ones(mem.shape), boxes)
    for k in ("ete2", "rg2", "bond_corr"):
        np.testing.assert_allclose(ps[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert abs(ps["mean_bond_length"] - want["mean_bond_length"]) <= 1e-6


def test_sdf_oracle(tmp_path):
    from groan_rs_tpu_torch import testing

    rng = np.random.default_rng(8)
    off = rng.uniform(-1.2, 1.2, (500, 3))
    off[:3] = [[0.0, 0.0, 0.0], [0.25 + 1e-7, 0.1, 0.1], [1.0, 0.3, 0.3]]   # at faces
    w = rng.uniform(1.0, 16.0, 500)
    sure, w_near, n_near = testing.host_sdf(off, w, 2.0, 8, 1e-5)
    assert n_near == 3 and abs(w_near - w[:3].sum()) < 1e-12
    u = np.floor((off[3:] + 1.0) / 0.25).astype(int)
    keep = ((u >= 0) & (u < 8)).all(1)
    assert abs(sure.sum() - w[3:][keep].sum()) < 1e-9
