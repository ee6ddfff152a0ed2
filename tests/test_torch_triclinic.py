"""Parity of the port's triclinic building blocks with groan_rs_tpu on the
same seeded numpy inputs, in three GROMACS-legal lower-triangular boxes:
an xy-square rhombic dodecahedron, a truncated octahedron and a general
box, with points on both sides of every face.

Tolerances: the triclinic `ops.pbc` forms 1e-5; `center_triclinic`,
weighted and masked, 1e-5; `prepare_coords_triclinic` and
`rmsd_frames_triclinic` RMSD 1e-5, rotations 1e-4; `angles` and
`dihedrals` with `triclinic=True` 1e-3 degrees; `rdf_normalization` on
`[B, 3, 3]` rtol 1e-5.  The chunked running-minimum pair path equals the
JAX dense `min_image_frames_any` route: min distance within 1e-5,
contacts and histogram counts exact.  The float64 27-image oracle of
`testing` equals a 125-image search.  The engine ships `[B, 3, 3]` boxes
through staging and refuses a resident window of the other box form."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groan_rs_tpu.core.simbox import SimBox as JSimBox
from groan_rs_tpu.io.traj import FrameBatch as JFrameBatch
from groan_rs_tpu.ops import center as jcenter
from groan_rs_tpu.ops import distances as jdist
from groan_rs_tpu.ops import geometry as jgeo
from groan_rs_tpu.ops import pbc as jpbc
from groan_rs_tpu.ops import rmsd as jrmsd

from _torch_parity import n, t
from groan_rs_tpu_torch import convert, testing
from groan_rs_tpu_torch.core.simbox import SimBox
from groan_rs_tpu_torch.errors import ParallelError
from groan_rs_tpu_torch.io.traj import FrameBatch, traj_iter
from groan_rs_tpu_torch.models import TrajectoryAnalysis as TTA
from groan_rs_tpu_torch.models import run_many
from groan_rs_tpu_torch.ops import center as tcenter
from groan_rs_tpu_torch.ops import distances as tdist
from groan_rs_tpu_torch.ops import geometry as tgeo
from groan_rs_tpu_torch.ops import kernels as K
from groan_rs_tpu_torch.ops import pbc as tpbc
from groan_rs_tpu_torch.ops import rmsd as trmsd
from groan_rs_tpu_torch.parallel import FrameEngine


def _octahedron(d):
    return np.array([[d, 0, 0], [d / 3, 2 * np.sqrt(2) * d / 3, 0],
                     [-d / 3, np.sqrt(2) * d / 3, np.sqrt(6) * d / 3]], np.float32)


BOXES = {"dodecahedron": testing.dodecahedron(5.0),
         "octahedron": _octahedron(5.5),
         "general": np.array([[5.0, 0, 0], [1.2, 4.5, 0], [-1.7, 2.0, 4.0]],
                             np.float32)}
SHIFTS125 = np.array([[i, j, k] for i in range(-2, 3) for j in range(-2, 3)
                      for k in range(-2, 3)], np.float64)


def _straddling(rng, h, n):
    """`n` points: fractional coordinates in [-1.5, 2.5), and a third of
    them within 1e-3 of a face plane (fractional 0 or 1) on one axis."""
    s = rng.uniform(-1.5, 2.5, (n, 3))
    k = n // 3
    ax = rng.integers(0, 3, k)
    s[np.arange(k), ax] = rng.integers(0, 2, k) + rng.uniform(-1e-3, 1e-3, k)
    return (s @ h.astype(np.float64)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(BOXES))
def box(request):
    """(name, box [3, 3], per-frame boxes [4, 3, 3], points a [4, 64, 3],
    b [4, 48, 3]): frame f's box is the base box scaled by 1 + f / 20."""
    h = BOXES[request.param]
    rng = np.random.default_rng(sorted(BOXES).index(request.param))
    hs = np.stack([h * np.float32(1 + f / 20) for f in range(4)])
    a = np.stack([_straddling(rng, hf, 64) for hf in hs])
    b = np.stack([_straddling(rng, hf, 48) for hf in hs])
    return request.param, h, hs, a, b


def _brute(d, h):
    """125-image search around `d` wrapped into the cell by the floor of its
    fractional coordinates (not the oracle's round)."""
    s = d @ np.linalg.inv(h)
    d = (s - np.floor(s)) @ h
    cands = d[:, None, :] + (SHIFTS125 @ h)[None]
    return cands[np.arange(d.shape[0]), np.argmin((cands * cands).sum(-1), 1)]


# ------------------------------------------------------------------- pbc


def test_shift_order():
    """The 27 image shifts in the JAX order, built on the device."""
    assert np.array_equal(n(tpbc._SHIFTS), np.asarray(jpbc._SHIFTS))
    h = torch.eye(3)[None] * 2.0
    assert torch.equal(tpbc._shift_vectors(h)[0], tpbc._SHIFTS * 2.0)


def test_box_inverse_and_volume(box):
    """The inverse (`inv_ex`, LU) against `jnp.linalg.inv` within rtol 1e-6;
    the volume (rule of Sarrus) equal to |`jnp.linalg.det`| bit for bit on
    these lower-triangular boxes: (v1x * v2y) * v3z."""
    _, _, hs, _, _ = box
    np.testing.assert_allclose(n(tpbc.box_inverse(t(hs))),
                               np.asarray(jnp.linalg.inv(hs)), rtol=1e-6,
                               atol=1e-7)
    vol = n(tpbc.box_volume(t(hs)))
    assert np.array_equal(vol, np.abs(np.asarray(jnp.linalg.det(hs))))
    assert np.array_equal(vol, (hs[:, 0, 0] * hs[:, 1, 1]) * hs[:, 2, 2])


@pytest.mark.parametrize("fn", ["min_image_triclinic", "distance_triclinic",
                                "wrap_triclinic"])
def test_single_box_forms(box, fn):
    _, h, _, a, b = box
    a, b = a[0, :48], b[0]
    args = (a, b) if fn == "distance_triclinic" else (a - b,)
    got = getattr(tpbc, fn)(*map(t, args), t(h))
    want = getattr(jpbc, fn)(*args, h)
    np.testing.assert_allclose(n(got), n(want), atol=1e-5)


@pytest.mark.parametrize("fn", ["min_image_triclinic_frames",
                                "distance_triclinic_frames",
                                "wrap_triclinic_frames", "min_image_frames_any"])
def test_frames_forms(box, fn):
    _, _, hs, a, b = box
    args = (a[:, :48], b) if fn == "distance_triclinic_frames" else (a[:, :48] - b,)
    got = getattr(tpbc, fn)(*map(t, args), t(hs))
    want = getattr(jpbc, fn)(*args, hs)
    np.testing.assert_allclose(n(got), n(want), atol=1e-5)


def test_frames_forms_single_and_pair_shapes(box):
    """[B, 3] displacements (one per frame), and min_image_frames_any on a
    [B, N, M, 3] pair block with matrices and with lengths."""
    _, _, hs, a, b = box
    d = a[:, 0] - b[:, 0]
    np.testing.assert_allclose(n(tpbc.min_image_triclinic_frames(t(d), t(hs))),
                               n(jpbc.min_image_triclinic_frames(d, hs)), atol=1e-5)
    pair = a[:, :8, None, :] - b[:, None, :6, :]
    np.testing.assert_allclose(n(tpbc.min_image_frames_any(t(pair), t(hs))),
                               n(jpbc.min_image_frames_any(pair, hs)), atol=1e-5)
    lengths = np.ascontiguousarray(np.diagonal(hs, axis1=1, axis2=2))
    assert np.array_equal(n(tpbc.min_image_frames_any(t(pair), t(lengths))),
                          n(jpbc.min_image_frames_any(pair, lengths)))


def test_oracle_equals_brute_force(box):
    """The float64 oracle (fractional round, 27 images) finds the image a
    125-image search finds, and the port's float32 image is as short."""
    _, h, _, a, b = box
    d = (a[0][:, None, :] - b[0][None, :, :]).reshape(-1, 3).astype(np.float64)
    got = testing.host_min_image_triclinic(d, h)
    want = _brute(d, h.astype(np.float64))
    np.testing.assert_allclose((got * got).sum(-1), (want * want).sum(-1),
                               rtol=1e-12, atol=1e-12)
    port = n(tpbc.min_image_triclinic(t(d.astype(np.float32)), t(h)))
    np.testing.assert_allclose(np.sqrt((port.astype(np.float64) ** 2).sum(-1)),
                               np.sqrt((want * want).sum(-1)), atol=1e-5)
    # the per-frame form of the oracle broadcasts box matrices
    per_frame = testing.host_min_image_triclinic(
        d.reshape(a.shape[1], -1, 3), np.broadcast_to(h, (a.shape[1], 1, 3, 3)))
    np.testing.assert_allclose(per_frame.reshape(-1, 3), got, atol=1e-12)


# ---------------------------------------------------------------- centre


@pytest.mark.parametrize("kind", ["geometric", "weighted", "masked"])
def test_center_triclinic(box, kind):
    _, h, hs, a, _ = box
    rng = np.random.default_rng(7)
    # a cluster around a cell corner: split by the faces
    pts = (rng.normal(size=a.shape) * 0.6).astype(np.float32)
    w = rng.uniform(1.0, 16.0, a.shape[1]).astype(np.float32)
    mask = rng.random(a.shape[1]) < 0.7
    kw = {"geometric": {}, "weighted": {"weights": w},
          "masked": {"weights": w, "mask": mask}}[kind]
    got = tcenter.center_triclinic(t(pts), t(hs), **{k: t(v) for k, v in kw.items()})
    want = jcenter.center_triclinic(pts, hs, **kw)
    np.testing.assert_allclose(n(got), n(want), atol=1e-5)
    one = tcenter.center_triclinic(t(pts[0]), t(h), **{k: t(v) for k, v in kw.items()})
    np.testing.assert_allclose(n(one), n(jcenter.center_triclinic(pts[0], h, **kw)),
                               atol=1e-5)


def test_center_triclinic_oracle(box):
    _, h, _, _, _ = box
    rng = np.random.default_rng(8)
    pts = (rng.normal(size=(500, 3)) * 0.6).astype(np.float32)
    w = rng.uniform(1.0, 16.0, 500).astype(np.float32)
    got = n(tcenter.center_triclinic(t(pts), t(h), weights=t(w)))
    want = testing.host_refined_center_triclinic(pts, h, w)
    d = testing.host_min_image_triclinic(got - want, h)
    assert np.abs(d).max() < 1e-5


# ------------------------------------------------------------------ rmsd


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else q * np.array([-1, 1, 1])


@pytest.fixture(scope="module")
def rmsd_frames(box):
    _, h, hs, _, _ = box
    rng = np.random.default_rng(9)
    ref = (rng.normal(size=(90, 3)) * 0.7).astype(np.float32)  # at the corner
    w = rng.uniform(1.0, 16.0, 90).astype(np.float32)
    fr = []
    for f in range(hs.shape[0]):
        x = ref @ _rotation(rng).T + rng.normal(size=ref.shape) * 0.05
        fr.append(testing.put_atoms_in_box(x.astype(np.float32), hs[f]))
    return ref, np.asarray(fr, np.float32), h, hs, w


def test_prepare_coords_triclinic(rmsd_frames):
    ref, _, h, _, w = rmsd_frames
    got, gc = trmsd.prepare_coords_triclinic(t(ref), t(h), weights=t(w))
    want, wc = jrmsd.prepare_coords_triclinic(ref, h, weights=w)
    np.testing.assert_allclose(n(got), n(want), atol=1e-5)
    np.testing.assert_allclose(n(gc), n(wc), atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_rmsd_frames_triclinic(rmsd_frames, masked):
    ref, fr, h, hs, w = rmsd_frames
    mask = (np.arange(ref.shape[0]) % 5 != 0) if masked else None
    jp, jc = jrmsd.prepare_coords_triclinic(ref, h, weights=w, mask=mask)
    tp, tc = trmsd.prepare_coords_triclinic(t(ref), t(h), weights=t(w),
                                            mask=None if mask is None else t(mask))
    r_t, rms_t = trmsd.rmsd_frames_triclinic(tp, tc, t(fr), t(hs), t(w),
                                             mask=None if mask is None else t(mask))
    r_j, rms_j = jrmsd.rmsd_frames_triclinic(jp, jc, fr, hs, w, mask=mask)
    np.testing.assert_allclose(n(rms_t), n(rms_j), atol=1e-5)
    np.testing.assert_allclose(n(r_t), n(r_j), atol=1e-4)
    if not masked:
        want = [testing.host_kabsch_rmsd_triclinic(ref, fr[f], h, hs[f], w)
                for f in range(fr.shape[0])]
        np.testing.assert_allclose(n(rms_t), want, atol=1e-5)


# -------------------------------------------------------------- geometry


def test_angles_dihedrals_triclinic(box):
    _, _, hs, a, b = box
    rng = np.random.default_rng(10)
    base = a[:, :20]
    step = (rng.normal(size=(3,) + base.shape) * 0.3).astype(np.float32)
    chain = [base, base + step[0], base + step[0] + step[1],
             base + step[0] + step[1] + step[2]]
    chain = [np.stack([testing.put_atoms_in_box(c[f], hs[f])
                       for f in range(hs.shape[0])]) for c in chain]
    got = tgeo.angles(*map(t, chain[:3]), t(hs), triclinic=True)
    want = jgeo.angles(*chain[:3], hs, triclinic=True)
    np.testing.assert_allclose(n(got), n(want), atol=1e-3)
    got = tgeo.dihedrals(*map(t, chain), t(hs), triclinic=True)
    want = np.asarray(jgeo.dihedrals(*chain, hs, triclinic=True))
    gap = n(got) - want
    np.testing.assert_allclose(gap - np.round(gap / 360) * 360, 0, atol=1e-3)
    oracle = testing.angles_host_f64(*chain[:3], hs.astype(np.float64))
    np.testing.assert_allclose(n(tgeo.angles(*map(t, chain[:3]), t(hs),
                                             triclinic=True)), oracle, atol=1e-3)


# ------------------------------------------------------------- pair path


def test_rdf_normalization_matrices(box):
    _, _, hs, _, _ = box
    got = tdist.rdf_normalization(t(hs), 64, 48, 2.0, 40)
    want = jdist.rdf_normalization(hs, 64, 48, 2.0, 40)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5)
    lengths = np.ascontiguousarray(np.diagonal(hs, axis1=1, axis2=2))[:3]
    np.testing.assert_allclose(n(tdist.rdf_normalization(t(lengths), 5, 5, 1.0, 10)),
                               n(jdist.rdf_normalization(lengths, 5, 5, 1.0, 10)),
                               rtol=1e-6)


@pytest.mark.parametrize("chunk_pairs", [1, 500, 1 << 22])
def test_pair_path_matches_jax_dense(box, chunk_pairs):
    """1 pair per chunk: one row at a time; 500: several rows per chunk."""
    _, _, hs, a, b = box
    d = jpbc.min_image_frames_any(a[:, :, None, :] - b[:, None, :, :], hs)
    dist = np.asarray(np.sqrt(np.sum(np.asarray(d) ** 2, -1)))
    got = tdist.min_distance_triclinic(t(a), t(b), t(hs), chunk_pairs=chunk_pairs)
    np.testing.assert_allclose(n(got), dist.min((1, 2)), atol=1e-5)
    for cut in (0.5, 1.0, 2.0):
        got = tdist.contact_count_triclinic(t(a), t(b), t(hs), cut,
                                            chunk_pairs=chunk_pairs)
        want = np.asarray(np.sum(np.asarray(dist) < np.float32(cut), (1, 2)))
        assert np.array_equal(n(got), want), cut
    got = tdist.pair_distance_histogram(t(a), t(b), t(hs), 2.5, 25,
                                        chunk_pairs=chunk_pairs)
    want = jdist.pair_distance_histogram(a, b, None, 2.5, 25, dist=dist)
    assert np.array_equal(n(got), np.asarray(want)) and n(got).sum() > 0
    same = tdist.pair_distance_histogram(t(a), t(a), t(hs), 2.5, 25,
                                         exclude_self=True, chunk_pairs=chunk_pairs)
    da = jpbc.min_image_frames_any(a[:, :, None, :] - a[:, None, :, :], hs)
    want = jdist.pair_distance_histogram(
        a, a, None, 2.5, 25, exclude_self=True,
        dist=np.sqrt(np.sum(np.asarray(da) ** 2, -1)))
    assert np.array_equal(n(same), np.asarray(want))


def test_pair_oracle(box):
    _, _, hs, a, b = box
    best, lo, hi = testing.host_pairs_triclinic(a[0], b[0], hs[0], 1.0)
    assert abs(float(n(tdist.min_distance_triclinic(t(a[:1]), t(b[:1]),
                                                    t(hs[:1])))[0]) - best) < 1e-5
    got = int(n(tdist.contact_count_triclinic(t(a[:1]), t(b[:1]), t(hs[:1]), 1.0))[0])
    assert lo <= got <= hi and hi > 0


# ----------------------------------------------------- box and the engine


def test_simbox_matrix_roundtrip(box):
    _, h, _, _, _ = box
    tb, jb = SimBox.from_matrix(h), JSimBox.from_matrix(h)
    assert np.array_equal(tb.to_matrix(), jb.to_matrix())
    assert np.array_equal(tb.to_matrix(), h) and not tb.is_orthogonal()
    b9 = np.asarray([[h[0, 0], h[1, 1], h[2, 2], h[0, 1], h[0, 2], h[1, 0],
                      h[1, 2], h[2, 0], h[2, 1]]] * 2, np.float32)
    kw = dict(positions=np.zeros((2, 1, 3), np.float32), boxes9=b9,
              steps=np.zeros(2, np.int64), times=np.zeros(2, np.float32),
              frame_numbers=np.arange(2))
    assert np.array_equal(FrameBatch(**kw).box_matrices(),
                          JFrameBatch(**kw).box_matrices())


@pytest.fixture(scope="module")
def tri_xtc(tmp_path_factory):
    """A 300-atom dodecahedron trajectory, 7 frames, and its System."""
    path = str(tmp_path_factory.mktemp("tri") / "tri.xtc")
    f0, h = testing.build_trajectory_triclinic(path, 300, 7, d=6.0)
    system = convert.system_from_state(testing.synthetic_state(f0, h))
    return path, h, system


@pytest.mark.parametrize("wire", ["f32", "q16"])
def test_engine_ships_matrices(tri_xtc, wire):
    path, h, system = tri_xtc
    engine = FrameEngine(lambda pos, bx, mask: {"boxes": bx}, "cpu", box="matrix")
    out = engine.run(traj_iter(system, path, batch_size=3).batches(wire=wire))
    assert out["boxes"].shape == (7, 3, 3)
    assert np.array_equal(out["boxes"], np.broadcast_to(h, (7, 3, 3)))
    dt = engine.materialize(traj_iter(system, path, batch_size=3).batches(wire=wire))
    assert dt.box_form == "matrix" and tuple(dt.boxes.shape) == (7, 3, 3)
    assert dt.kind == wire
    res = engine.run_resident(dt, batch_size=3)
    assert np.array_equal(res["boxes"], out["boxes"])
    with pytest.raises(ParallelError):
        FrameEngine(lambda *a: {}, "cpu", box="cube")


def test_other_box_form_is_refused(tri_xtc):
    path, _, system = tri_xtc
    tri = TTA(system, device="cpu", triclinic=True).add_com("Protein").runner(
        ship="all")
    ortho = TTA(system, device="cpu").add_com("Protein").runner(ship="all")
    dt_tri = tri.load_device(path, batch_size=3)
    dt_ortho = ortho.load_device(path, batch_size=3)
    assert dt_ortho.box_form == "lengths" and tuple(dt_ortho.boxes.shape) == (7, 3)
    for runner, dt in ((tri, dt_ortho), (ortho, dt_tri)):
        with pytest.raises(ParallelError, match="box"):
            runner.run(dt)
        with pytest.raises(ParallelError, match="box"):
            run_many([runner], dt)
        with pytest.raises(ParallelError, match="box"):
            runner.engine.run_resident_fused(dt)
    assert tri.run(dt_tri)["com_Protein"].shape == (7, 3)


def test_orthorhombic_kernels_refuse_matrices():
    """The K1/K2/K3 wrappers raise for [B, 3, 3] boxes, in both of the
    shapes a step could hand them, instead of broadcasting."""
    pos = torch.zeros(2, 5, 3)
    hs = torch.eye(3).expand(2, 3, 3) * 4.0
    for box in (hs, hs[:, None, :]):
        with pytest.raises(ValueError):
            K.bai_breen_estimate(pos, None, box)
        with pytest.raises(ValueError):
            K.pair_reduce(pos, pos, box, 0.5)
