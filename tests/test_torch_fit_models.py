"""The fitted analyses of the PyTorch port's `models/structure.py` (rmsf,
pca, entropy, rotmat, dccm, rmsdist) against groan_rs_tpu's on the same
System state and XTC, on the CPU: the 3,000-atom synthetic layout with
the residue and atom names of `testing.named_layout` (30 ten-atom protein
residues), 12 frames, in the 21 nm cube and in the rhombic dodecahedron.

Tolerances: RMSF, fitted RMSD, rotations, distances and PCA means 1e-5
(nm); eigenvalues 1e-4 of the largest; eigenvectors |cos| >= 1 - 1e-4
for modes whose eigenvalue stands 1e-3 of the largest apart from both
neighbours (the others are degenerate: 90 modes from 12 frames);
entropies relative 1e-4; the DCCM covariance 1e-4 of its largest entry,
and the DCCM within what that covariance error allows after the
normalisation, 1e-4 max|C| / sqrt(C_ii C_jj), plus 1e-6.  Errors raise the
JAX package's class and code."""

import numpy as np
import pytest

from groan_rs_tpu import models as J

from _torch_parity import named_pairs, raised
from groan_rs_tpu_torch import models as T
from groan_rs_tpu_torch.errors import ParallelError

FORMS = ("ortho", "triclinic")


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return named_pairs(tmp_path_factory)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("fit", [True, False])
def test_rmsf(pairs, form, fit):
    xtc, js, ts = pairs[form]
    ji, jr = J.rmsf(js, xtc, "Protein", fit=fit)
    ti, tr = T.rmsf(ts, xtc, "Protein", fit=fit)
    assert np.array_equal(ji, ti)
    assert np.abs(tr - jr).max() <= 1e-5


def _modes_close(a, b):
    lam = a["eigenvalues"]
    scale = lam[0]
    assert np.abs(b["eigenvalues"] - lam).max() <= 1e-4 * scale
    gap = np.minimum(np.abs(np.diff(lam, prepend=np.inf)),
                     np.abs(np.diff(lam, append=-np.inf)))
    sep = np.flatnonzero(gap > 1e-3 * scale)
    assert sep.size >= 5
    cos = np.abs((a["eigenvectors"][sep] * b["eigenvectors"][sep]).sum((1, 2)))
    assert cos.min() >= 1 - 1e-4
    return sep


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mass_weighted", [True, False])
def test_pca(pairs, form, mass_weighted):
    xtc, js, ts = pairs[form]
    a = J.pca(js, xtc, "CA", mass_weighted=mass_weighted, n_components=40)
    b = T.pca(ts, xtc, "CA", mass_weighted=mass_weighted, n_components=40)
    assert b["eigenvectors"].shape == (40, 30, 3) and b["projections"].shape == (12, 40)
    assert np.array_equal(a["indices"], b["indices"])
    assert np.abs(b["mean"] - a["mean"]).max() <= 1e-5
    assert abs(b["trace"] - a["trace"]) <= 1e-4 * a["eigenvalues"][0]
    assert np.array_equal(a["sqrt_weights"], b["sqrt_weights"])
    sep = _modes_close(a, b)
    sign = np.sign((a["eigenvectors"][sep] * b["eigenvectors"][sep]).sum((1, 2)))
    scale = np.sqrt(a["eigenvalues"][0])
    assert np.abs(b["projections"][:, sep] * sign - a["projections"][:, sep]).max() \
        <= 1e-4 * scale


@pytest.mark.parametrize("form", FORMS)
def test_entropy(pairs, form):
    xtc, js, ts = pairs[form]
    a = J.entropy(js, xtc, "CA", temperature=310.0)
    b = T.entropy(ts, xtc, "CA", temperature=310.0)
    for key in ("schlitter", "quasiharmonic"):
        assert abs(b[key] - a[key]) <= 1e-4 * abs(a[key])


@pytest.mark.parametrize("form", FORMS)
def test_rotmat(pairs, form):
    xtc, js, ts = pairs[form]
    a = J.rotmat(js, xtc, "Protein")
    b = T.rotmat(ts, xtc, "Protein")
    assert np.abs(b["matrices"] - a["matrices"]).max() <= 1e-5
    assert np.abs(b["rmsd"] - a["rmsd"]).max() <= 1e-5


@pytest.mark.parametrize("form", FORMS)
def test_dccm(pairs, form):
    xtc, js, ts = pairs[form]
    a = J.dccm(js, xtc, "CA")
    b = T.dccm(ts, xtc, "CA")
    c = a["covariance"].astype(np.float64)
    tol = 1e-4 * np.abs(c).max()
    assert np.abs(b["covariance"] - c).max() <= tol
    var = np.diag(c)
    allowed = tol / np.sqrt(np.outer(var, var)) + 1e-6
    assert (np.abs(b["dccm"] - a["dccm"]) <= allowed).all()
    assert np.array_equal(np.diag(b["dccm"]), np.ones(30, np.float32))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("pbc_aware", [False, True])
def test_rmsdist(pairs, form, pbc_aware):
    xtc, js, ts = pairs[form]
    a = J.rmsdist(js, xtc, "CA", pbc_aware=pbc_aware, chunk=8)
    b = T.rmsdist(ts, xtc, "CA", pbc_aware=pbc_aware, chunk=7)
    for key in ("rmsdist", "ref_distances", "mean_deviation"):
        assert np.abs(b[key] - a[key]).max() <= 1e-5, key


def test_device_trajectory_layouts(pairs):
    """A window shipped with every atom, and one of the group alone, give
    the filename's results; a window without the group is refused."""
    xtc, js, ts = pairs["ortho"]
    want = T.rmsf(ts, xtc, "Protein")[1]
    full = T.TrajectoryAnalysis(ts, device="cpu").runner(ship="all").load_device(xtc)
    assert np.array_equal(T.rmsf(ts, full, "Protein")[1], want)
    ca = T.TrajectoryAnalysis(ts, device="cpu").runner(group="CA").load_device(xtc)
    assert np.array_equal(T.pca(ts, ca, "CA")["eigenvalues"],
                          T.pca(ts, xtc, "CA")["eigenvalues"])
    jca = J.TrajectoryAnalysis(js).runner(group="CA").load_device(xtc)
    assert raised(lambda: J.rmsf(js, jca, "Protein")) \
        == raised(lambda: T.rmsf(ts, ca, "Protein")) == ("ParallelError", "ParallelError")


ERRORS = {
    "empty group": lambda M, s, x: M.rmsf(s, x, "Empty"),
    "missing group": lambda M, s, x: M.dccm(s, x, "Nowhere"),
    "reference mismatch": lambda M, s, x: M.rotmat(s, x, "Protein", reference=s.group_extract("CA")),
    "one frame pca": lambda M, s, x: M.pca(s, _one_frame(M, s, x), "CA"),
    "one frame dccm": lambda M, s, x: M.dccm(s, _one_frame(M, s, x), "CA"),
    "temperature": lambda M, s, x: M.entropy(s, x, "CA", temperature=0.0),
    "rmsdist reference atoms": lambda M, s, x: M.rmsdist(s, x, "CA", reference=s.group_extract("CA")),
}


def _one_frame(M, s, x):
    ta = M.TrajectoryAnalysis(s) if M is J else M.TrajectoryAnalysis(s, device="cpu")
    return ta.runner(group="CA").load_device(x, end_time=0.0)


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_match_jax(pairs, case):
    xtc, js, ts = pairs["ortho"]
    for s in (js, ts):
        if "Empty" not in s.get_groups():
            s.group_create_from_indices("Empty", np.zeros(0, np.int64))
    want = raised(lambda: ERRORS[case](J, js, xtc))
    assert want is not None
    assert raised(lambda: ERRORS[case](T, ts, xtc)) == want


def test_pca_mesh_refused(pairs):
    xtc, _, ts = pairs["ortho"]
    with pytest.raises(ParallelError, match="item 11"):
        T.pca(ts, xtc, "CA", mesh=object())
