"""Principal-mode tools and morphing of the PyTorch port (`models.
subspace_overlap`, `cosine_content`, `mode_traj`, `morph`) against
groan_rs_tpu's on the CPU: the 3,000-atom named synthetic layout over 12
frames (its 30 alpha carbons for the PCA), frames 0 and 11 as morph
endpoints.

Tolerances: the host tools exact on the same inputs (they are float64
numpy in both packages); the overlap of the two PCA halves within 1e-4
over the 4 leading modes; morph frames and endpoint RMSDs within 1e-5 nm;
written trajectories byte-identical where the frames are (mode_traj,
morph without a fit), else read back within half of 1/precision.  Errors
raise the JAX package's class and code."""

import numpy as np
import pytest

from groan_rs_tpu import models as J

from _torch_parity import named_pairs, raised
from groan_rs_tpu_torch import models as T
from groan_rs_tpu_torch.io import native


@pytest.fixture(scope="module")
def named(tmp_path_factory):
    xtc, js, ts = named_pairs(tmp_path_factory)["ortho"]
    offs, _, _, nat = native.xtc_scan(xtc)
    coords, *_ = native.xtc_read_frames(xtc, offs, nat)
    return xtc, js, ts, coords


def _halves(M, s, xtc):
    ta = M.TrajectoryAnalysis(s) if M is J else M.TrajectoryAnalysis(s, device="cpu")
    runner = ta.runner(group="CA")
    return [M.pca(s, runner.load_device(xtc, start_time=a, end_time=b), "CA")
            for a, b in ((0.0, 50.0), (60.0, 110.0))]


def test_subspace_overlap(named):
    xtc, js, ts, _ = named
    ja, jb = _halves(J, js, xtc)
    ta, tb = _halves(T, ts, xtc)
    for n in (None, 4):
        want = J.subspace_overlap(ja, jb, n=n)
        got = T.subspace_overlap(ja, jb, n=n)
        assert got["n"] == want["n"] and np.array_equal(got["inner"], want["inner"])
        for key in ("subspace_overlap", "rmsip", "covariance_overlap"):
            assert got[key] == want[key]
    want, got = J.subspace_overlap(ja, jb, n=4), T.subspace_overlap(ta, tb, n=4)
    for key in ("subspace_overlap", "rmsip", "covariance_overlap"):
        assert abs(got[key] - want[key]) <= 1e-4, key


def test_cosine_content(named):
    xtc, js, ts, _ = named
    proj = J.pca(js, xtc, "CA")["projections"]
    assert np.array_equal(T.cosine_content(proj, n_modes=6),
                          J.cosine_content(proj, n_modes=6))
    assert T.cosine_content(proj[:, 0]) == J.cosine_content(proj[:, 0])
    got = T.cosine_content(T.pca(ts, xtc, "CA")["projections"][:, :3])
    assert np.abs(got - J.cosine_content(proj[:, :3])).max() <= 1e-4


@pytest.mark.parametrize("mode,amplitude", [(1, None), (3, 0.5)])
def test_mode_traj(named, tmp_path, mode, amplitude):
    xtc, js, ts, _ = named
    res = J.pca(js, xtc, "CA")
    paths = [str(tmp_path / f"{p}.xtc") for p in ("j", "t")]
    want = J.mode_traj(js, res, "CA", mode=mode, amplitude=amplitude, n=10, phases=2,
                       output=paths[0])
    got = T.mode_traj(ts, res, "CA", mode=mode, amplitude=amplitude, n=10, phases=2,
                      output=paths[1])
    for key in ("frames", "displacement"):
        assert np.array_equal(got[key], want[key])
    assert got["amplitude"] == want["amplitude"]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    res_t = T.pca(ts, xtc, "CA")
    frames = T.mode_traj(ts, res_t, "CA", n=10)["frames"]
    assert np.abs(frames - J.mode_traj(js, res, "CA", n=10)["frames"]).max() <= 1e-4


def _endpoints(M, s, coords):
    a, b = s.copy(), s.copy()
    a.positions[:] = coords[0]
    b.positions[:] = coords[11]
    return a, b


@pytest.mark.parametrize("fit", [True, False])
def test_morph(named, tmp_path, fit):
    xtc, js, ts, coords = named
    ja, jb = _endpoints(J, js, coords)
    ta, tb = _endpoints(T, ts, coords)
    paths = [str(tmp_path / f"{p}.xtc") for p in ("j", "t")]
    want = J.morph(ja, jb, n=7, first=-0.2, last=1.1, fit=fit, group="Protein",
                   output=paths[0])
    got = T.morph(ta, tb, n=7, first=-0.2, last=1.1, fit=fit, group="Protein",
                  output=paths[1])
    assert np.array_equal(got["lambdas"], want["lambdas"])
    assert np.abs(got["frames"] - want["frames"]).max() <= 1e-5
    for key in ("rmsd_a", "rmsd_b"):
        assert np.abs(got[key] - want[key]).max() <= 1e-5
    assert "__morph_fit" not in ta.get_groups()
    if not fit:
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            assert a.read() == b.read()
    prot = ta.group_extract("Protein")
    back = np.stack([s.positions.copy() for s in prot.xtc_iter(paths[1])])
    assert np.abs(back - got["frames"]).max() <= 0.5 / ta.get_precision() + 1e-6


def test_morph_from_file(named, tmp_path):
    """A GRO endpoint loads as a System without masses: both packages
    refuse the mass-weighted fit the same way."""
    xtc, js, ts, coords = named
    ja, _ = _endpoints(J, js, coords)
    ta, tb = _endpoints(T, ts, coords)
    gro = str(tmp_path / "b.gro")
    tb.write_gro(gro)
    want = raised(lambda: J.morph(ja, gro, n=4, group="resid 1 to 30"))
    assert want == ("RMSDError", "InvalidMass")
    assert raised(lambda: T.morph(ta, gro, n=4, group="resid 1 to 30")) == want


ERRORS = {
    "mode range": lambda M, s, r: M.mode_traj(s, r, "CA", mode=0),
    "mode_traj n": lambda M, s, r: M.mode_traj(s, r, "CA", n=1),
    "mode_traj atoms": lambda M, s, r: M.mode_traj(s, r, "Protein"),
    "morph n": lambda M, s, r: M.morph(s, s.copy(), n=1),
    "morph atoms": lambda M, s, r: M.morph(s, s.group_extract("Protein")),
    "morph group": lambda M, s, r: M.morph(s, s.copy(), group="Nowhere"),
    "overlap shapes": lambda M, s, r: M.subspace_overlap(
        r, {"eigenvectors": r["eigenvectors"][:, :5], "eigenvalues": r["eigenvalues"]}),
    "overlap n": lambda M, s, r: M.subspace_overlap(r, r, n=0),
    "cosine shape": lambda M, s, r: M.cosine_content(np.zeros((1, 3))),
    "cosine n_modes": lambda M, s, r: M.cosine_content(np.ones((4, 3)), n_modes=0),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_match_jax(named, case):
    xtc, js, ts, _ = named
    res = J.pca(js, xtc, "CA", n_components=6)
    want = raised(lambda: ERRORS[case](J, js, res))
    assert want is not None
    assert raised(lambda: ERRORS[case](T, ts, res)) == want
