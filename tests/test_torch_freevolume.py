"""Free volume by probe insertion (`models.freevolume`) in the PyTorch port
against the JAX package, and the port's host draw (`utils.threefry`)
against `jax.random.uniform` bit for bit.

The same seeded draw and the same atoms go through both packages: free
fractions must be equal (a probe flips only within float32 reach of a
sphere's surface; none does here).  The JAX tests' analytic checks keep
their tolerance (3e-3 of the fraction at 200,000 samples) and the exact
float64 oracle on injected points its 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import frames_pair, raised
from groan_rs_tpu import models as jmodels
from groan_rs_tpu_torch import models as tmodels
from groan_rs_tpu_torch.utils import threefry

BOX = np.array([4.0, 4.0, 4.0], np.float32)
TRI = np.array([[4.0, 0.0, 0.0], [0.0, 4.0, 0.0], [2.0, 2.0, 2.8284271]], np.float32)


@pytest.mark.parametrize("seed", [0, 1, 7, 123456, 2 ** 31 - 1, 2 ** 32 + 5])
@pytest.mark.parametrize("shape", [(1,), (3, 5, 3), (4, 8192, 3), (2, 1000, 7)])
def test_uniform_equals_jax_random(seed, shape):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, jnp.float32))
    got = threefry.uniform(seed, shape)
    assert got.dtype == np.float32 and got.shape == tuple(shape)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 99, 2 ** 33 + 1])
def test_key_and_bits_equal_jax(seed):
    key = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    assert threefry.prng_key(seed) == tuple(int(k) for k in key)
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (5, 11), jnp.uint32))
    assert np.array_equal(threefry.random_bits(threefry.prng_key(seed), (5, 11)), want)


def _pair(tmp_path, atoms, vdw, box=BOX):
    atoms = np.asarray(atoms, np.float32)
    if atoms.ndim == 2:
        atoms = atoms[None]
    return frames_pair(tmp_path / "fv.xtc", atoms, box, {"Sel": np.arange(atoms.shape[1])},
                       vdw=np.asarray(vdw, np.float32))


def _sphere_vol(r):
    return 4.0 / 3.0 * np.pi * r ** 3


@pytest.mark.parametrize("case", ["single", "probe", "corner", "pair"])
def test_analytic_volumes(tmp_path, case):
    atoms, vdw, probe, seed, occupied = {
        "single": ([[2.0, 2.0, 2.0]], [0.8], 0.0, 3, _sphere_vol(0.8)),
        "probe": ([[2.0, 2.0, 2.0]], [0.5], 0.3, 5, _sphere_vol(0.8)),
        "corner": ([[0.05, 0.05, 3.95]], [0.7], 0.0, 7, _sphere_vol(0.7)),
        "pair": ([[1.0, 1.0, 1.0], [3.0, 3.0, 3.0]], [0.5, 0.6], 0.0, 11,
                 _sphere_vol(0.5) + _sphere_vol(0.6)),
    }[case]
    xtc, js, ts = _pair(tmp_path, atoms, vdw)
    out = tmodels.freevolume(ts, xtc, "Sel", probe=probe, n_samples=200_000, seed=seed)
    want = jmodels.freevolume(js, xtc, "Sel", probe=probe, n_samples=200_000, seed=seed)
    for k in ("fraction", "free_volume", "box_volume"):
        assert np.array_equal(out[k], want[k]), k
    assert (out["mean_fraction"], out["stderr_fraction"], out["n_samples"]) == \
        (want["mean_fraction"], want["stderr_fraction"], want["n_samples"])
    assert out["mean_fraction"] == pytest.approx(1.0 - occupied / 64.0, abs=3e-3)


@pytest.mark.parametrize("box", [BOX, TRI], ids=["cube", "triclinic"])
@pytest.mark.parametrize("seed", [0, 42])
def test_random_atoms_equal_jax(tmp_path, box, seed):
    rng = np.random.default_rng(seed)
    atoms = rng.uniform(0, 3.5, size=(3, 40, 3))
    vdw = rng.uniform(0.1, 0.4, size=40)
    xtc, js, ts = _pair(tmp_path, atoms, vdw, box)
    out = tmodels.freevolume(ts, xtc, "Sel", probe=0.05, n_samples=3000, seed=seed,
                             chunk=700)
    want = jmodels.freevolume(js, xtc, "Sel", probe=0.05, n_samples=3000, seed=seed)
    assert np.array_equal(out["fraction"], want["fraction"])
    np.testing.assert_allclose(out["box_volume"], want["box_volume"], rtol=1e-12)


def test_exact_oracle_on_injected_points(tmp_path):
    rng = np.random.default_rng(13)
    n, f, p = 24, 3, 500
    atoms = rng.uniform(0, 4, size=(f, n, 3))
    vdw = rng.uniform(0.1, 0.4, size=n)
    xtc, js, ts = _pair(tmp_path, atoms, vdw)
    pts_unit = rng.uniform(0, 1, size=(f, p, 3)).astype(np.float32)
    out = tmodels.freevolume(ts, xtc, "Sel", points=pts_unit, probe=0.05)
    want = jmodels.freevolume(js, xtc, "Sel", points=pts_unit, probe=0.05)
    assert np.array_equal(out["fraction"], want["fraction"])
    q = np.round(atoms * 100000.0) / 100000.0
    box = np.asarray(BOX, np.float64)
    r2 = (np.asarray(vdw, np.float32) + np.float32(0.05)) ** 2
    for fi in range(f):
        d = pts_unit[fi].astype(np.float64)[:, None, :] * box - q[fi][None, :, :]
        d -= np.round(d / box) * box
        free = ((d * d).sum(-1) > np.asarray(r2, np.float64)[None, :]).all(axis=1)
        assert out["fraction"][fi] == pytest.approx(free.mean(), abs=2e-5)


def test_chunking_invariance(tmp_path):
    rng = np.random.default_rng(17)
    xtc, _, ts = _pair(tmp_path, rng.uniform(0, 4, size=(2, 10, 3)), np.full(10, 0.3))
    a = tmodels.freevolume(ts, xtc, "Sel", n_samples=4096, seed=1, chunk=64)
    b = tmodels.freevolume(ts, xtc, "Sel", n_samples=4096, seed=1, chunk=4096)
    assert np.array_equal(a["fraction"], b["fraction"])


def test_errors(tmp_path):
    xtc, js, ts = frames_pair(tmp_path / "e.xtc", np.array([[[2.0, 2.0, 2.0]]]), BOX,
                              {"Sel": [0]})
    for kw in ({}, {"radii": [0.1, 0.2]}, {"radii": [0.1], "points": np.zeros((3, 10, 3))}):
        t = raised(lambda: tmodels.freevolume(ts, xtc, "Sel", **kw))
        assert t is not None
        assert t == raised(lambda: jmodels.freevolume(js, xtc, "Sel", **kw))


@pytest.mark.parametrize("box", [BOX, TRI], ids=["cube", "triclinic"])
def test_host_free_points(box):
    """`testing.host_free_points` (the phase-16 oracle) against brute force
    over the minimum image."""
    from groan_rs_tpu_torch import testing

    rng = np.random.default_rng(6)
    atoms = rng.uniform(0, 4, (30, 3))
    r = rng.uniform(0.2, 0.6, 30)
    xyz = rng.uniform(0, 1, (400, 3)) @ (box if box.ndim == 2 else np.diag(box))
    free, near = testing.host_free_points(xyz, atoms, box, r)
    d = np.sqrt((testing._mi(xyz[:, None] - atoms[None], box) ** 2).sum(-1))
    assert np.array_equal(free, (d > r).all(1))
    assert not near.any() and 0 < free.sum() < 400
