"""SASA (`ops/sasa.py`, `models.sasa`) in the PyTorch port against the JAX
package: the same points through both, then the JAX tests' closed forms
and the float64 all-neighbour oracle (`test_sasa.py`'s tolerances: rtol
1e-5 for a lone sphere, 3e-3 for the analytic cap at 4,096 points, rtol
2e-4 / atol 1e-5 against the oracle, rtol 1e-6 / atol 1e-7 between
chunkings).  Port against JAX: areas within atol 1e-6 nm^2 (float32
rounding of the same arithmetic), relevant-neighbour counts exact, and
the `max_neighbors` guard raising the same error at the same cap."""

import numpy as np
import pytest
import torch

from _torch_parity import frames_pair, raised
from groan_rs_tpu import models as jmodels
from groan_rs_tpu.ops import sasa as jsasa
from groan_rs_tpu_torch import models as tmodels
from groan_rs_tpu_torch.ops import sasa as tsasa

BOX = np.array([10.0, 10.0, 10.0], np.float32)
TRI = np.array([[4.0, 0.0, 0.0], [0.0, 4.0, 0.0], [2.0, 2.0, 2.8284271]], np.float32)


def _both(pts, radii, box=BOX, **kw):
    """(port areas, port count, JAX areas, JAX count) of one frame."""
    pts = np.asarray(pts, np.float32)[None]
    boxes = np.asarray(box, np.float32)[None]
    radii = np.asarray(radii, np.float32)
    ta, tn = tsasa.sasa_frames(torch.from_numpy(pts), torch.from_numpy(boxes), radii, **kw)
    ja, jn = jsasa.sasa_frames(pts, boxes, radii, **kw)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    assert tn == int(jn)
    return ta.numpy()[0], tn


def test_fibonacci_sphere_equal():
    for n in (1, 12, 192, 4096):
        assert np.array_equal(tsasa.fibonacci_sphere(n), jsasa.fibonacci_sphere(n))


def test_isolated_atom_full_sphere():
    area, nrel = _both([[5.0, 5.0, 5.0]], [0.17], probe=0.14)
    assert nrel == 0
    np.testing.assert_allclose(area[0], 4 * np.pi * 0.31 ** 2, rtol=1e-5)


def test_two_spheres_analytic_cap():
    r, probe, d = 0.2, 0.1, 0.4
    big_r = r + probe
    area, nrel = _both([[5.0, 5.0, 5.0], [5.0 + d, 5.0, 5.0]], [r, r], probe=probe,
                       n_points=4096)
    assert nrel == 1
    expect = 4 * np.pi * big_r ** 2 - 2 * np.pi * big_r * (big_r - d / 2)
    np.testing.assert_allclose(area, [expect, expect], rtol=3e-3)


def test_buried_atom_is_zero():
    phi = (1 + np.sqrt(5)) / 2
    verts = np.array([[0, 1, phi], [0, -1, phi], [0, 1, -phi], [0, -1, -phi],
                      [1, phi, 0], [-1, phi, 0], [1, -phi, 0], [-1, -phi, 0],
                      [phi, 0, 1], [-phi, 0, 1], [phi, 0, -1], [-phi, 0, -1]])
    verts /= np.linalg.norm(verts[0])
    pts = np.vstack([[0.0, 0.0, 0.0], verts * 0.25]) + 5.0
    area, _ = _both(pts, [0.1] + [0.2] * 12, probe=0.14, n_points=512)
    assert area[0] == 0.0 and (area[1:] > 0).all()


@pytest.mark.parametrize("box", [BOX, TRI], ids=["cube", "triclinic"])
def test_pbc_split_pair_matches_contiguous(box):
    d = 0.35
    contiguous = np.array([[2.0, 2.0, 1.0], [2.0 + d, 2.0, 1.0]])
    split = np.array([[box[0][0] - d / 2 if box.ndim == 2 else box[0] - d / 2, 2.0, 1.0],
                      [d / 2, 2.0, 1.0]])
    a1, _ = _both(contiguous, [0.2, 0.2], box=box, probe=0.1)
    a2, _ = _both(split, [0.2, 0.2], box=box, probe=0.1)
    np.testing.assert_allclose(a2, a1, rtol=1e-5)


@pytest.mark.parametrize("box,seed", [(BOX, 12), (BOX, 3), (TRI, 12), (TRI, 4)])
def test_random_cluster_matches_host_oracle(box, seed):
    rng = np.random.default_rng(seed)
    k = 40
    centre = 6.0 if box.ndim == 1 else 1.0       # the triclinic cluster crosses the cell
    pts = (rng.uniform(-0.6, 0.6, size=(k, 3)) + centre).astype(np.float32)
    radii = rng.uniform(0.1, 0.25, size=k).astype(np.float32)
    area, _ = _both(pts, radii, box=box, probe=0.14, max_neighbors=k - 1)
    for oracle in (tsasa.sasa_frames_host_f64, jsasa.sasa_frames_host_f64):
        expect = oracle(pts[None], np.asarray([box]), radii, probe=0.14)[0]
        np.testing.assert_allclose(area, expect, rtol=2e-4, atol=1e-5)


def test_chunking_invariance():
    rng = np.random.default_rng(5)
    k = 37
    pts = torch.from_numpy((rng.uniform(-0.5, 0.5, size=(2, k, 3)) + 4.0).astype(np.float32))
    radii = rng.uniform(0.1, 0.2, size=k).astype(np.float32)
    boxes = torch.from_numpy(np.stack([BOX, BOX]))
    a_one, n_one = tsasa.sasa_frames(pts, boxes, radii, chunk=k)
    for chunk in (1, 8, 36):
        a, n = tsasa.sasa_frames(pts, boxes, radii, chunk=chunk)
        np.testing.assert_allclose(a.numpy(), a_one.numpy(), rtol=1e-6, atol=1e-7)
        assert n == n_one


@pytest.mark.parametrize("box", [BOX, TRI], ids=["cube", "triclinic"])
def test_models_pipeline_and_guards(tmp_path, box):
    rng = np.random.default_rng(9)
    k, f = 24, 6
    frames = (rng.uniform(-0.5, 0.5, size=(f, k, 3)) + 3.0).astype(np.float32)
    radii = rng.uniform(0.1, 0.2, size=k).astype(np.float32)
    xtc, js, ts = frames_pair(tmp_path / "c.xtc", frames, box, {"Sel": np.arange(k)},
                              precision=10000)
    for kw in ({}, {"radii": radii[:3]}):
        t = raised(lambda: tmodels.sasa(ts, xtc, "Sel", **kw))
        assert t == raised(lambda: jmodels.sasa(js, xtc, "Sel", **kw))
        assert t == ("GroupError", "InvalidVdW")
    out = tmodels.sasa(ts, xtc, "Sel", radii=radii)
    want = jmodels.sasa(js, xtc, "Sel", radii=radii)
    assert np.array_equal(out["indices"], want["indices"])
    np.testing.assert_allclose(out["area"], want["area"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["total"], want["total"], rtol=1e-6)
    boxes = np.repeat(np.asarray(box, np.float64)[None], f, axis=0)
    expect = tsasa.sasa_frames_host_f64(np.round(frames.astype(np.float64) * 1e4) / 1e4,
                                        boxes, radii)
    np.testing.assert_allclose(out["area"], expect, rtol=2e-4, atol=1e-5)
    # the cap: the same error at the same count, in both packages
    n_rel = tsasa.sasa_frames(torch.from_numpy(frames), torch.from_numpy(
        boxes.astype(np.float32)), radii)[1]
    for cap in (2, n_rel - 1, n_rel):
        t = raised(lambda: tmodels.sasa(ts, xtc, "Sel", radii=radii, max_neighbors=cap))
        assert t == raised(lambda: jmodels.sasa(js, xtc, "Sel", radii=radii, max_neighbors=cap))
        assert t == (None if cap >= n_rel else ("ParallelError", "ParallelError"))
    from groan_rs_tpu_torch.models import TrajectoryAnalysis

    dt = TrajectoryAnalysis(ts, device="cpu",
                            triclinic=box.ndim == 2).runner(group="Sel").load_device(xtc)
    assert np.array_equal(tmodels.sasa(ts, dt, "Sel", radii=radii)["area"], out["area"])


def test_topology_radii(tmp_path):
    rng = np.random.default_rng(2)
    k = 20
    frames = (rng.uniform(-0.5, 0.5, size=(2, k, 3)) + 3.0).astype(np.float32)
    vdw = rng.uniform(0.1, 0.2, size=k).astype(np.float32)
    xtc, js, ts = frames_pair(tmp_path / "v.xtc", frames, BOX, {"Sel": np.arange(k)},
                              vdw=vdw)
    out = tmodels.sasa(ts, xtc, "Sel", probe=0.1, n_points=64)
    want = jmodels.sasa(js, xtc, "Sel", probe=0.1, n_points=64)
    np.testing.assert_allclose(out["area"], want["area"], rtol=0, atol=1e-6)
    assert np.array_equal(out["area"], tmodels.sasa(ts, xtc, "Sel", probe=0.1, n_points=64,
                                                    radii=vdw)["area"])


@pytest.mark.parametrize("box", [BOX, TRI], ids=["cube", "triclinic"])
def test_host_sasa_sample_oracle(box):
    """`testing.host_sasa` (the phase-16 oracle over sampled atoms) equals
    the all-pairs oracle and counts the relevant neighbours as the port."""
    from groan_rs_tpu_torch import testing

    rng = np.random.default_rng(21)
    k = 50
    pts = (rng.uniform(-0.7, 0.7, size=(k, 3)) + 1.0).astype(np.float32)
    radii = rng.uniform(0.1, 0.25, size=k).astype(np.float32)
    rows = np.array([0, 7, 19, 49])
    area, count, slack = testing.host_sasa(pts, box, radii.astype(np.float64) + 0.14, rows)
    full = tsasa.sasa_frames_host_f64(pts[None], np.asarray([box]), radii)[0]
    np.testing.assert_allclose(area, full[rows], rtol=1e-12, atol=1e-12)
    assert (slack >= 0).all()
    _, n_max = tsasa.sasa_frames(torch.from_numpy(pts[None]), torch.from_numpy(box[None]),
                                 radii, max_neighbors=k - 1)
    assert count.max() <= n_max
