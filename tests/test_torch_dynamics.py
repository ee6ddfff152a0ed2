"""The time-correlation and transport analyses of the PyTorch port's
`models/dynamics.py` against groan_rs_tpu's on the same System state and
files, on the CPU: the 3,000-atom synthetic layout with the full topology
(charges, bonds, masses), 16 frames of XTC in the 21 nm cube and in the
rhombic dodecahedron, and a TRR of the cube's first 12 frames with seeded
AR(1) velocities (`testing.ar1_velocities`).

Tolerances, as `chip_smoke.py` phase 14 holds the card to float64:
curves (msd, msd_mol, rotacf, vacf, dipole_corr) within relative 1e-4 of
their largest value, diffusion coefficients, dos's T, dof and spectrum
within relative 1e-4, tcaf's normalised curves within 1e-4 and nu, eta_k
and eta0 within relative 1e-3 (normalised points held away from the
floor), `current` within twice `testing.current_bound` (each package
within it of float64); Van Hove counts exact but for the norms within
1e-6 nm of a shell edge; filtered frames read back within 1/precision
plus two float32 ulps.  Errors raise the JAX package's class and code."""

import numpy as np
import pytest

from groan_rs_tpu import models as J
from groan_rs_tpu.models import pipeline as JP

from _torch_parity import raised, synthetic_pair
from groan_rs_tpu_torch import models as T
from groan_rs_tpu_torch import testing
from groan_rs_tpu_torch.io import native
from groan_rs_tpu_torch.models import dynamics as TD
from groan_rs_tpu_torch.models import pipeline as TP

N_FRAMES, N_TRR = 16, 12
FORMS = ("ortho", "triclinic")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """{form: (xtc, jax System, port System, wrapped coords, boxes)} and the
    cube's TRR path with its velocities."""
    out = {}
    for form in FORMS:
        path = tmp_path_factory.mktemp(form) / "dyn.xtc"
        xtc, js, ts = synthetic_pair(path, n_frames=N_FRAMES, triclinic=form == "triclinic")
        offs, _, _, nat = native.xtc_scan(xtc)
        coords, b9, steps, times = native.xtc_read_frames(xtc, offs, nat)[:4]
        boxes = b9.reshape(-1, 3, 3) if form == "triclinic" else b9[:, [0, 4, 8]]
        out[form] = (xtc, js, ts, coords, boxes.astype(np.float64))
        for s in (js, ts):
            s.group_create_from_indices("Empty", [])
        if form == "ortho":
            cube = [x[:N_TRR] for x in (coords, b9, times, steps)]
    vel = testing.ar1_velocities(N_TRR, nat, seed=11)
    trr = str(tmp_path_factory.mktemp("trr") / "dyn.trr")
    testing.write_trr(trr, *cube, vel)
    out["trr"] = (trr, vel)
    return out


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dims", ["xyz", "xy", "z"])
def test_msd(data, form, dims):
    xtc, js, ts, coords, boxes = data[form]
    jt, jc = J.msd(js, xtc, "Water", dims=dims)
    tt, tc = T.msd(ts, xtc, "Water", dims=dims)
    assert np.array_equal(jt, tt) and tc.dtype == np.float32
    _close(tc, jc)
    axes = ["xyz".index(c) for c in dims]
    w = ts.group_indices("Water")
    _close(tc, testing.host_msd(testing.host_unwrap(coords[:, w], boxes), tt / 10, axes))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dims", ["xyz", "xy"])
def test_diffusion(data, form, dims):
    xtc, js, ts = data[form][:3]
    a = J.diffusion(js, xtc, "Water", dims=dims, fit_range=(0.2, 0.8))
    b = T.diffusion(ts, xtc, "Water", dims=dims, fit_range=(0.2, 0.8))
    assert np.array_equal(a["fit_mask"], b["fit_mask"])
    for key in ("D", "D_1e5", "slope"):
        assert abs(b[key] - a[key]) <= 1e-4 * abs(a[key])
    _close(b["msd"], a["msd"])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dims", ["xyz", "xy"])
def test_msd_mol(data, form, dims):
    xtc, js, ts, coords, boxes = data[form]
    a = J.msd_mol(js, xtc, "Membrane", dims=dims)
    b = T.msd_mol(ts, xtc, "Membrane", dims=dims)
    assert b["n_molecules"] == a["n_molecules"] == 20
    assert np.array_equal(b["first_atom"], a["first_atom"])
    _close(b["msd"], a["msd"])
    _close(b["D"], a["D"])
    g = ts.group_indices("Membrane")
    u = testing.host_unwrap(coords[:, g], boxes)
    com = testing.host_com_paths(u, ts.topology.molecule_ids()[g], ts.topology.mass[g])
    want = testing.host_msd(com, np.arange(N_FRAMES), ["xyz".index(c) for c in dims],
                            per_entity=True)
    _close(b["msd"], want)
    again = T.msd_mol(ts, xtc, "Membrane", dims=dims)
    assert np.array_equal(again["msd"], b["msd"])


@pytest.mark.parametrize("mass_weighted", [False, True])
def test_vacf(data, mass_weighted):
    trr, vel = data["trr"]
    js, ts = data["ortho"][1:3]
    jt, jc = J.vacf(js, trr, "Water", mass_weighted=mass_weighted)
    tt, tc = T.vacf(ts, trr, "Water", mass_weighted=mass_weighted)
    assert np.array_equal(jt, tt)
    _close(tc, jc)
    w = ts.group_indices("Water")
    _close(tc, testing.host_lag_corr(vel[:, w], np.arange(N_TRR),
                                     ts.topology.mass[w] if mass_weighted else None))


def test_dos(data):
    trr, vel = data["trr"]
    js, ts = data["ortho"][1:3]
    a, b = J.dos(js, trr, "Water"), T.dos(ts, trr, "Water")
    for key in ("T", "dof", "D"):
        assert abs(b[key] - a[key]) <= 1e-4 * abs(a[key])
    for key in ("dos", "vacf"):
        _close(b[key], a[key])
    assert np.array_equal(b["nu"], a["nu"]) and b["n_atoms"] == a["n_atoms"]
    w = ts.group_indices("Water")
    m = ts.topology.mass[w]
    t = np.arange(N_TRR) * 10.0
    want = testing.host_dos(testing.host_lag_corr(vel[:, w], np.arange(N_TRR), m),
                            testing.host_lag_corr(vel[:, w], np.arange(N_TRR)), t,
                            float(m.astype(np.float64).sum()), len(w))
    for key in ("T", "dof", "D"):
        assert abs(b[key] - want[key]) <= 1e-4 * abs(want[key])
    _close(b["dos"], want["dos"])


def _water_axes(ts):
    oxy = np.flatnonzero(ts.topology.atomname.values() == "OW")
    oxy = oxy[oxy + 1 < ts.get_n_atoms()]
    return np.stack([oxy + 1, oxy], 1)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("order", [1, 2])
def test_rotacf(data, form, order):
    xtc, js, ts, coords, boxes = data[form]
    pairs = _water_axes(ts)
    jt, jc = J.rotacf(js, xtc, pairs, order=order)
    tt, tc = T.rotacf(ts, xtc, pairs, order=order)
    assert np.array_equal(jt, tt)
    _close(tc, jc)
    u = testing.host_unit_vectors(coords[:, pairs[:, 0]], coords[:, pairs[:, 1]], boxes)
    _close(tc, testing.host_lag_corr(u, np.arange(N_FRAMES), order=order))


@pytest.mark.parametrize("form", FORMS)
def test_current(data, form):
    xtc, js, ts, coords, boxes = data[form]
    a, b = J.current(js, xtc), T.current(ts, xtc)
    assert np.array_equal(a["fit_mask"], b["fit_mask"])
    assert abs(b["volume"] - a["volume"]) <= 1e-12 * a["volume"]
    q = ts.topology.charge.astype(np.float64)
    u = testing.host_unwrap(coords, boxes)
    mj = testing.host_dipole_paths(u, q)
    lags = np.arange(N_FRAMES)
    want = np.array([((mj[lag:] - mj[:N_FRAMES - lag]) ** 2).sum(1).mean() for lag in lags])
    bound = testing.current_bound(q, float(np.abs(u).max()), want)
    for got, lim in ((b["mj2"], bound), (a["mj2"], bound), (b["mj2"], 2 * bound)):
        ref = want if lim is bound else a["mj2"]
        assert (np.abs(got - ref)[1:] <= lim[1:]).all()
    slope, _, mask = testing.host_fit(a["lag_times"], want, 0.1, 0.5, positive=True)
    pinv = np.linalg.pinv(np.stack([a["lag_times"][mask], np.ones(int(mask.sum()))], 1))
    slope_bound = np.abs(pinv[0]) @ bound[mask]
    assert abs(b["slope"] - slope) <= slope_bound
    assert abs(b["conductivity"] - a["conductivity"]) <= 2 * slope_bound / slope * abs(
        a["conductivity"])


@pytest.mark.parametrize("form", FORMS)
def test_vanhove(data, form):
    xtc, js, ts, coords, boxes = data[form]
    lags = [1, 3, 8, 15]
    a = J.vanhove(js, xtc, "Water", lags=lags, r_max=1.0, bins=40)
    b = T.vanhove(ts, xtc, "Water", lags=lags, r_max=1.0, bins=40)
    assert b["counts"].dtype == np.int64 and np.array_equal(b["lags"], a["lags"])
    k = len(ts.group_indices("Water"))
    total = b["counts"].sum(1) + np.rint(b["overflow"] * (N_FRAMES - np.asarray(lags)) * k)
    assert np.array_equal(total, (N_FRAMES - np.asarray(lags)) * k)
    w = ts.group_indices("Water")
    host, edge = testing.host_vanhove(testing.host_unwrap(coords[:, w], boxes), lags, 1.0, 40)
    for ref in (a["counts"], host[:, :40]):
        moved = np.abs(b["counts"] - ref).sum(1) // 2
        assert (moved <= edge).all()
    _close(b["gs"], a["gs"], rel=1e-12 + edge.max() / k)
    again = T.vanhove(ts, xtc, "Water", lags=lags, r_max=1.0, bins=40)
    assert np.array_equal(again["counts"], b["counts"])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("wrap", [False, True])
def test_filter_traj(data, tmp_path, form, wrap):
    xtc, js, ts, coords, boxes = data[form]
    outs = {}
    for tag, mod, sysm in (("jax", J, js), ("torch", T, ts)):
        path = str(tmp_path / f"{tag}.xtc")
        assert mod.filter_traj(sysm, xtc, path, window=5, group="Protein", wrap=wrap) == N_FRAMES
        offs, _, times, nat = native.xtc_scan(path)
        outs[tag] = native.xtc_read_frames(path, offs, nat)
        assert np.array_equal(times, np.arange(N_FRAMES) * 10.0)
    got, want = outs["torch"][0], outs["jax"][0]
    quantum = 1.0 / float(outs["torch"][4][0])
    p = ts.group_indices("Protein")
    assert got.shape == (N_FRAMES, len(p), 3)
    ulp = np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(got - want).max() <= quantum + 2 * ulp
    sm = testing.host_filtered(testing.host_unwrap(coords[:, p], boxes), 5)
    d = got - sm
    if wrap:           # the same point modulo the cell
        d = np.stack([testing._mi(d[f], boxes[f]) for f in range(N_FRAMES)])
    assert np.abs(d).max() <= quantum / 2 + 2 * ulp


def _tcaf_margin(cn, floor):
    """Distance of the normalised points around each mode's crossing of
    the floor from the floor."""
    out = []
    for row in cn:
        bad = np.flatnonzero(row <= floor)
        stop = int(bad[0]) if bad.size else len(row)
        out.append(np.abs(row[:stop + 1] - floor).min())
    return min(out)


def test_tcaf(data):
    trr, vel = data["trr"]
    js, ts, coords = data["ortho"][1:4]
    a, b = J.tcaf(js, trr, "Water", n_k=4), T.tcaf(ts, trr, "Water", n_k=4)
    assert _tcaf_margin(a["tcaf"], 0.3) > 1e-3
    assert np.abs(b["tcaf"] - a["tcaf"]).max() <= 1e-4
    for key in ("nu", "eta_k"):
        assert (np.abs(b[key] - a[key]) <= 1e-3 * np.abs(a[key])).all()
    assert abs(b["eta0"] - a["eta0"]) <= 1e-3 * abs(a["eta0"])
    assert np.array_equal(b["k"], a["k"]) and b["rho"] == a["rho"]
    w = ts.group_indices("Water")
    host = testing.host_tcaf(coords[:N_TRR, w], vel[:, w], ts.topology.mass[w],
                             np.full(3, 21.0), 4, 0.3, 10.0)
    assert np.abs(b["tcaf"] - host["tcaf"]).max() <= 1e-4
    assert (np.abs(b["nu"] - host["nu"]) <= 1e-3 * np.abs(host["nu"])).all()


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mode", ["total", "mol"])
def test_dipole_corr(data, form, mode):
    xtc, js, ts, coords, boxes = data[form]
    a = J.dipole_corr(js, xtc, "Water", mode=mode)
    b = T.dipole_corr(ts, xtc, "Water", mode=mode)
    assert np.array_equal(a["lag_times"], b["lag_times"])
    assert np.abs(b["corr"] - a["corr"]).max() <= 1e-4 * abs(a["corr"][0])
    assert abs(b["corr_time"] - a["corr_time"]) <= 1e-4 * max(abs(a["corr_time"]), 1.0)
    if mode == "mol":
        w = ts.group_indices("Water")
    w = ts.group_indices("Water")
    tot, mu = testing.host_molecular_dipoles(coords[:, w], boxes, ts.topology.molecule_ids()[w],
                                             ts.topology.mass[w], ts.topology.charge[w])
    want = testing.host_lag_corr(tot[:, None, :] if mode == "total" else mu, np.arange(N_FRAMES))
    assert np.abs(b["corr"] - want).max() <= 1e-4 * abs(want[0])


def test_unit_tables_equal_jax(data):
    js, ts = data["ortho"][1:3]
    idx = ts.group_indices("all")[::2]
    gsel = np.arange(0, ts.get_n_atoms())
    mol = ts.topology.molecule_ids()[idx]
    order, blocks = [], {}
    for local, m in enumerate(mol):             # the JAX dipole_corr's blocks
        blocks.setdefault(int(m), []).append(local)
        if len(blocks[int(m)]) == 1:
            order.append(int(m))
    jblocks = [blocks[k] for k in order]
    _, tblocks = TP._blocks_by_key(mol)
    assert [list(b) for b in tblocks] == jblocks
    loc = np.searchsorted(gsel, idx)
    for charges in (False, True):
        want = JP._unit_tables(js, idx, jblocks, loc, charges=charges)
        got = TP._unit_tables(ts, idx, tblocks, loc, charges=charges)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True)


NAMES = ("msd", "vacf", "diffusion", "msd_mol", "dos", "hbond_acf", "hbond_lifetime",
         "rotacf", "current", "vanhove", "filter_traj", "tcaf", "dipole_corr",
         "_hbond_curve", "_hbond_h_matrix")


@pytest.mark.parametrize("name", NAMES)
def test_pipeline_forwarding(name):
    assert getattr(TP, name) is getattr(TD, name)
    if not name.startswith("_"):
        assert getattr(T, name) is getattr(TD, name) and name in T.__all__


def _windows(mod, system, path, group, velocities=False):
    ta = mod.TrajectoryAnalysis(system) if mod is J else mod.TrajectoryAnalysis(
        system, device="cpu")
    return (ta.runner(ship="all", velocities=velocities).load_device(path),
            ta.runner(group=group, velocities=velocities).load_device(path))


def test_resident_equals_from_file(data):
    xtc, js, ts = data["ortho"][:3]
    trr = data["trr"][0]
    want = T.msd(ts, xtc, "Water")[1]
    for dt in _windows(T, ts, xtc, "Water"):
        assert np.array_equal(T.msd(ts, dt, "Water")[1], want)
    want = T.vacf(ts, trr, "Water", mass_weighted=True)[1]
    for dt in _windows(T, ts, trr, "Water", velocities=True):
        assert np.array_equal(T.vacf(ts, dt, "Water", mass_weighted=True)[1], want)
    narrow = {mod: _windows(mod, s, xtc, "Protein")[1] for mod, s in ((J, js), (T, ts))}
    for fn in ("msd", "msd_mol", "vanhove", "current"):
        a = raised(lambda: getattr(J, fn)(js, narrow[J], "Water"))
        b = raised(lambda: getattr(T, fn)(ts, narrow[T], "Water"))
        assert a == b and a[0] == "ParallelError", fn


def _window(m, s, path, group):
    return _windows(m, s, path, group)[1]


# name -> (the System's box form, the call on either package)
ERRORS = {
    "msd empty group": ("ortho", lambda m, s, d: m.msd(s, d["xtc"], "Empty")),
    "msd bad dims": ("ortho", lambda m, s, d: m.msd(s, d["xtc"], "Water", dims="xq")),
    "msd repeated dims": ("ortho", lambda m, s, d: m.msd(s, d["xtc"], "Water", dims="xx")),
    "msd lag out of range": ("ortho", lambda m, s, d: m.msd(s, d["xtc"], "Water",
                                                             lags=[0, N_FRAMES])),
    "msd negative lag": ("ortho", lambda m, s, d: m.msd(s, d["xtc"], "Water", lags=[-1])),
    "msd_mol no lags": ("ortho", lambda m, s, d: m.msd_mol(s, d["xtc"], "Membrane", lags=[])),
    "msd_mol bad dims": ("ortho", lambda m, s, d: m.msd_mol(s, d["xtc"], "Membrane", dims="")),
    "diffusion fit_range order": ("ortho", lambda m, s, d: m.diffusion(
        s, d["xtc"], "Water", fit_range=(0.6, 0.2))),
    "diffusion narrow window": ("ortho", lambda m, s, d: m.diffusion(
        s, d["xtc"], "Water", fit_range=(0.5, 0.51))),
    "current fit_range order": ("ortho", lambda m, s, d: m.current(s, d["xtc"],
                                                                   fit_range=(0.5, 0.1))),
    "current temperature": ("ortho", lambda m, s, d: m.current(s, d["xtc"], temperature=0.0)),
    "current few lags": ("ortho", lambda m, s, d: m.current(s, d["xtc"], lags=[0, 1])),
    "vacf no velocities": ("ortho", lambda m, s, d: m.vacf(
        s, _window(m, s, d["xtc"], "Water"), "Water")),
    "vacf empty group": ("ortho", lambda m, s, d: m.vacf(s, d["trr"], "Empty")),
    "tcaf no velocities": ("ortho", lambda m, s, d: m.tcaf(
        s, _window(m, s, d["xtc"], "Water"), "Water")),
    "tcaf triclinic": ("triclinic", lambda m, s, d: m.tcaf(s, d["triclinic"], "Water")),
    "tcaf fluctuating box": ("ortho", lambda m, s, d: m.tcaf(s, d["breathing"], "Water")),
    "tcaf non-uniform grid": ("ortho", lambda m, s, d: m.tcaf(s, d["jittered"], "Water")),
    "tcaf three frames": ("ortho", lambda m, s, d: m.tcaf(s, d["short"], "Water")),
    "dos two frames": ("ortho", lambda m, s, d: m.dos(s, d["two"], "Water")),
    "dos non-uniform grid": ("ortho", lambda m, s, d: m.dos(s, d["jittered"], "Water")),
    "dos temperature": ("ortho", lambda m, s, d: m.dos(s, d["trr"], "Water", temperature=-1.0)),
    "filter even window": ("ortho", lambda m, s, d: m.filter_traj(s, d["xtc"], "unused.xtc",
                                                                  window=4)),
    "rotacf order 3": ("ortho", lambda m, s, d: m.rotacf(s, d["xtc"], [[0, 1]], order=3)),
    "rotacf pairs out of range": ("ortho", lambda m, s, d: m.rotacf(
        s, d["xtc"], [[0, 1], [2, 10 ** 6]])),
    "rotacf pairs shape": ("ortho", lambda m, s, d: m.rotacf(s, d["xtc"], [0, 1, 2])),
    "rotacf pairs outside window": ("ortho", lambda m, s, d: m.rotacf(
        s, _window(m, s, d["xtc"], "Protein"), [[0, 2999]])),
    "vanhove lag zero": ("ortho", lambda m, s, d: m.vanhove(s, d["xtc"], "Water", lags=[0, 1])),
    "vanhove lag past the end": ("ortho", lambda m, s, d: m.vanhove(s, d["xtc"], "Water",
                                                                    lags=[N_FRAMES])),
    "dipole_corr mode": ("ortho", lambda m, s, d: m.dipole_corr(s, d["xtc"], "Water",
                                                                mode="site")),
    "dipole_corr lags": ("triclinic", lambda m, s, d: m.dipole_corr(
        s, d["triclinic_xtc"], "Water", mode="mol", lags=[N_FRAMES])),
}


@pytest.fixture(scope="module")
def error_data(data, tmp_path_factory):
    """The files of the error cases: the cube's XTC and TRR, the
    dodecahedron's XTC and a TRR in its box, and four-frame TRRs with a
    fluctuating box, a non-uniform time grid, three and two frames."""
    base = tmp_path_factory.mktemp("errors")
    xtc, _, ts, coords, _ = data["ortho"]
    n = ts.get_n_atoms()
    v = testing.ar1_velocities(4, n, seed=3)
    b9 = np.tile(np.diag(np.full(3, 21.0, np.float32)).reshape(9), (4, 1))
    tri = data["triclinic"][0]
    tri_coords, tri_b9 = native.xtc_read_frames(tri, native.xtc_scan(tri)[0][:4], n)[:2]
    files = {"xtc": xtc, "trr": data["trr"][0], "triclinic_xtc": tri}
    for name, (c, boxes, times) in {
            "breathing": (coords, b9 * (1 + 0.01 * np.arange(4))[:, None], np.arange(4) * 10.0),
            "jittered": (coords, b9, np.array([0.0, 10.0, 25.0, 30.0])),
            "short": (coords, b9[:3], np.arange(3) * 10.0),
            "two": (coords, b9[:2], np.arange(2) * 10.0),
            "triclinic": (tri_coords, tri_b9, np.arange(4) * 10.0)}.items():
        files[name] = str(base / f"{name}.trr")
        testing.write_trr(files[name], c[:len(boxes)], boxes.astype(np.float32), times,
                          np.arange(len(boxes)), v)
    return files


@pytest.mark.parametrize("case", list(ERRORS))
def test_errors_match_jax(data, error_data, case, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    form, fn = ERRORS[case]
    js, ts = data[form][1:3]
    a = raised(lambda: fn(J, js, error_data))
    b = raised(lambda: fn(T, ts, error_data))
    assert a is not None and a == b, (a, b)
