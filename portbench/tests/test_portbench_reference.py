"""The plain reference against the float64 oracles it was frozen from
(`groan_rs_tpu_torch/testing.py`), frame by frame at a small size."""

import numpy as np
import pytest
import torch

from portbench.conftest import tiny
from groan_rs_tpu_torch import testing as T
from portbench.gen.synthetic import Synthetic
from portbench.reference import judge
from portbench.reference import plain as O


def _frames(name, seed=31, frames=3):
    _, config, traffic = tiny(name, frames=frames)
    syn = Synthetic(config, seed, "cpu")
    p = torch.stack([syn.positions(q) for _, q in syn.grid_frames()])
    fr = judge.Frames(syn, p, torch.float64, analysis=traffic["analysis"])
    return syn, fr, traffic


@pytest.mark.parametrize("name", ["main-resident", "main-dodec-streamed"])
def test_main_path_oracles(name):
    syn, fr, traffic = _frames(name)
    g = fr.groups
    prot, mem, pep = g["Protein"], g["Membrane"], g["Peptide"]
    w = fr.mass[prot].numpy()
    want = judge.reference_outputs(fr, traffic["analysis"])
    p = fr.p.numpy()
    h = syn.h.astype(np.float64)
    box = h if syn.triclinic else np.diag(h)
    ref0 = fr.ref_frame().numpy()
    for f in range(p.shape[0]):
        x = p[f]
        if syn.triclinic:
            ca = T.host_refined_center_triclinic(x[prot], h, w)
            cb = T.host_refined_center_triclinic(x[mem], h)
            d = T.host_min_image_triclinic(ca - cb, h)
            rmsd = T.host_kabsch_rmsd_triclinic(ref0[prot], x[prot], h, h, w)
            best, lo, hi = T.host_pairs_triclinic(x[pep], x[mem], h, 0.4)
            np.testing.assert_array_equal([want["contacts"][0][f], want["contacts"][1][f]],
                                          [lo, hi])
        else:
            ca = T.host_refined_center(x[prot], box, w)
            cb = T.host_refined_center(x[mem], box)
            d = ca - cb
            d -= box * np.round(d / box)
            c0 = T.host_refined_center(ref0[prot], box, w)
            ref = np.mod(ref0[prot] + (box / 2 - c0), box) - box / 2
            rmsd = T.host_kabsch_rmsd(ref, np.zeros(3), x[prot], box, w)
            best = T.host_min_distance(x[pep], x[mem], box)
        np.testing.assert_allclose(want["com"][f].numpy(), ca, atol=1e-9)
        assert want["dist"][f] == pytest.approx(np.sqrt((d * d).sum()), abs=1e-9)
        assert want["rmsd"][0][f] == pytest.approx(rmsd, abs=1e-9)
        assert want["mindist"][f] == pytest.approx(best, abs=1e-12)


def test_observable_oracles():
    syn, fr, traffic = _frames("observables-streamed", frames=2)
    want = judge.reference_outputs(fr, traffic["analysis"])
    g = fr.groups
    prot, mem, wat, pep = g["Protein"], g["Membrane"], g["Water"], g["Peptide"]
    lay = syn.layout()
    mass, q = fr.mass.numpy(), fr.charge.numpy()
    box = np.diag(syn.h).astype(np.float64)
    cyl = type("Cylinder", (), {"position": syn.cylinder_args()[0],
                                "radius": syn.cylinder_args()[1],
                                "height": syn.cylinder_args()[2],
                                "orientation": type("D", (), {"name": "Z"})()})()
    for f in range(fr.p.shape[0]):
        x = fr.p[f].numpy()
        rel = dict(rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(want["gyration"][f].numpy(),
                                   T.host_gyration(x[prot], box, mass[prot], True), **rel)
        np.testing.assert_allclose(want["principal"][0][f].numpy(),
                                   T.host_principal(x[prot], box, mass[prot]), rtol=1e-9)
        np.testing.assert_allclose(want["dipole"][0][f].numpy(),
                                   T.host_dipole(x[prot], box, q[prot], mass[prot]), **rel)
        np.testing.assert_allclose(
            want["total_dipole"][f].numpy(),
            T.host_total_dipole(x[wat], box, q[wat], (np.arange(wat.stop - wat.start)) // 3),
            **rel)
        hyd = lay["lipid_hydrogens"]
        with np.errstate(invalid="ignore"):
            np.testing.assert_allclose(want["order"][0][f].numpy(),
                                       T.host_order(x[hyd - 1], x[hyd], box, [0, 0, 1]), **rel)
        t, d4 = lay["water_angles"], lay["lipid_dihedrals"]
        xb = x[None]
        np.testing.assert_allclose(
            want["angles"][0][f].numpy(),
            T.angles_host_f64(xb[:, t[:, 0]], xb[:, t[:, 1]], xb[:, t[:, 2]], box[None])[0],
            atol=1e-9)
        np.testing.assert_allclose(
            want["dihedrals"][0][f].numpy(),
            T.dihedrals_host_f64(*(xb[:, d4[:, k]] for k in range(4)), box[None])[0],
            atol=1e-9)
        lo, hi = T.host_density_map(x[mem], (0, 1), ((0.0, box[0]), (0.0, box[1])),
                                    int(round(box[0] / 0.1)), int(round(box[1] / 0.1)))
        np.testing.assert_array_equal(want["density_map"][0][f].numpy(), lo)
        np.testing.assert_array_equal(want["density_map"][1][f].numpy(), hi)
        lo, hi = T.host_pair_histogram(x[pep], x[mem], box, 2.0, 200)
        np.testing.assert_array_equal(want["rdf"][0][f].numpy(), lo)
        np.testing.assert_array_equal(want["rdf"][1][f].numpy(), hi)
        lo, hi = T.host_in_shape(x[wat], box, cyl)
        assert (int(want["in_shape"][0][f]), int(want["in_shape"][1][f])) == (lo, hi)
        for key, wt, scale in (("profile_mass", mass[wat], 1.66053906660),
                               ("profile_charge", q[wat], 1.0)):
            prof, slack = T.host_density_profile_triclinic(x[wat], np.diag(box), 2, 200, wt,
                                                          scale)
            np.testing.assert_allclose(want[key][0][f].numpy(), prof, rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(want[key][1][f].numpy(), slack, rtol=1e-9, atol=1e-12)
    assert float(want["box_volume"][0]) == pytest.approx(216.0)
    np.testing.assert_allclose(want["box_lengths"][0].numpy(), [6.0, 6.0, 6.0])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, 1.0 + 3 * 2.0 ** -11, -21.3])
    got = O.to_tf32(x)
    # ties to even at the 10th fraction bit
    assert got[:4].tolist() == [1.0, 1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9]
    assert abs(float(got[4]) + 21.3) <= 21.3 * 2.0 ** -11
    assert got.dtype == torch.float32


def test_conditioned_comparison_forgives_collinear_sites():
    """An angle whose arm is near zero may take any float answer; a
    well-conditioned one may not."""
    want = torch.tensor([[90.0, 90.0]], dtype=torch.float64)
    scale = torch.rad2deg(torch.tensor([[1e-6, 1e6]], dtype=torch.float64))
    ok = judge.error("cond", torch.tensor([[90.0, 10.0]]), (want, scale))
    bad = judge.error("cond", torch.tensor([[90.1, 90.0]]), (want, scale))
    assert ok < 1e-5 and bad > 1e3
    nan = judge.error("cond", torch.tensor([[float("nan"), 90.0]]), (want, scale))
    assert nan == float("inf")
    # with a period (dihedrals): a gap of a whole turn is no gap
    turn = judge.error("cond", torch.tensor([[-270.0, 90.0]]), (want, scale, 360.0))
    assert turn < 1e-5


@pytest.mark.parametrize("name", ["main-resident", "main-dodec-streamed"])
def test_flipped_rmsd_equals_the_fit_of_flipped_frames(name, monkeypatch):
    """Each subset's RMSD from the covariance updates equals the plain fit
    of the frame with those atoms moved to their other image."""
    monkeypatch.setattr(O, "FLIP_TOL", 0.5)     # candidates on every frame
    syn, fr, _ = _frames(name, frames=2)
    g = fr.groups["Protein"]
    w = fr.weights("Protein")
    ref, p, box = fr.ref_frame()[g], fr.group("Protein"), fr.box
    values = O.kabsch_rmsd_flips(ref, fr.ref_box(), p, box, w)
    com = O.refined_center(p, box, w)
    if syn.triclinic:
        atom, delta = O.wrap_flips(p - com[:, None, :], box)
    else:
        half = box / 2
        qc = torch.remainder(p + (half - com)[:, None, :], box[:, None, :]) - half[:, None, :]
        atom, delta = O.wrap_flips(qc, box)
    assert (delta.abs().sum(-1) > 0).any()
    masks = O.subsets(atom.shape[1], p)
    for s in (1, 2, 5, masks.shape[0] - 1):
        moved = p.clone()
        for f in range(p.shape[0]):
            for k in range(atom.shape[1]):
                if masks[s, k]:
                    moved[f, atom[f, k]] += delta[f, k]
        if syn.triclinic:
            # the oracle's image of each atom, then the flips
            u = com[:, None, :] + O.min_image(p - com[:, None, :], box)
            for f in range(p.shape[0]):
                for k in range(atom.shape[1]):
                    if masks[s, k]:
                        u[f, atom[f, k]] += delta[f, k]
            uc = u - ((w[None, :, None] * u).sum(1) / w.sum())[:, None, :]
            c0 = O.refined_center(ref[None], fr.ref_box()[None], w)
            r = c0[:, None, :] + O.min_image(ref[None] - c0[:, None, :], fr.ref_box()[None])
            pc = r - ((w[None, :, None] * r).sum(1) / w.sum())[:, None, :]
            want = O._kabsch(pc.expand(p.shape[0], -1, -1), uc, torch.ones_like(w), w)
        else:
            q = qc.clone()
            for f in range(p.shape[0]):
                for k in range(atom.shape[1]):
                    if masks[s, k]:
                        q[f, atom[f, k]] += delta[f, k]
            c0 = O.refined_center(ref[None], fr.ref_box()[None], w)
            hr = fr.ref_box() / 2
            pc = torch.remainder(ref[None] + (hr - c0)[:, None, :], fr.ref_box()) - hr
            want = O._kabsch(pc.expand(p.shape[0], -1, -1), q, w, w)
        np.testing.assert_allclose(values[:, s].numpy(), want.numpy(), rtol=1e-6, atol=1e-7)


def test_flip_aware_dipole_forgives_a_flip_only():
    want = torch.tensor([[10.0, 0.0, 0.0]], dtype=torch.float64)
    deltas = torch.tensor([[[5.25, 0.0, 0.0], [0.0, 0.0, 0.0]]], dtype=torch.float64)
    flipped = judge.error("flipvec", torch.tensor([[15.25, 0.0, 0.0]]), (want, deltas))
    off = judge.error("flipvec", torch.tensor([[10.01, 0.0, 0.0]]), (want, deltas))
    assert flipped < 1e-7 and off == pytest.approx(1e-3, rel=1e-3)


def test_flipped_principal_moments(monkeypatch):
    """Each subset's moments equal the plain ones of the frame with those
    atoms moved to their other image (two flips of one atom included)."""
    monkeypatch.setattr(O, "FLIP_TOL", 0.6)
    syn, fr, _ = _frames("observables-streamed", frames=2)
    p, box, w = fr.group("Protein"), fr.box, fr.weights("Protein")
    values = O.principal_flips(p, box, w)
    d = O.min_image(p - O.refined_center(p, box, w)[:, None, :], box)
    atom, delta = O.wrap_flips(d, box)
    assert (delta.abs().sum(-1) > 0).any()
    masks = O.subsets(atom.shape[1], p)
    eye = torch.eye(3, dtype=p.dtype)
    for s in range(0, masks.shape[0], 17):
        dd = d.clone()
        for f in range(p.shape[0]):
            for k in range(atom.shape[1]):
                if masks[s, k]:
                    dd[f, atom[f, k]] += delta[f, k]
        inertia = (eye[None] * (w * (dd * dd).sum(-1)).sum(1)[:, None, None]
                   - (w[None, :, None] * dd).transpose(1, 2) @ dd)
        np.testing.assert_allclose(values[:, s].numpy(), torch.linalg.eigvalsh(inertia).numpy(),
                                   rtol=1e-9)


@pytest.mark.parametrize("name", ["main-resident", "main-dodec-streamed"])
def test_reference_frame_flips(name, monkeypatch):
    """A flip of the reference frame's own wrap moves every frame's RMSD:
    each reference variant equals the fit against the reference with that
    atom moved to its other image."""
    monkeypatch.setattr(O, "FLIP_TOL", 0.5)
    syn, fr, _ = _frames(name, frames=2)
    g = fr.groups["Protein"]
    w = fr.weights("Protein")
    ref, p, box = fr.ref_frame()[g], fr.group("Protein"), fr.box
    variants = O._reference_variants(ref, fr.ref_box(), w)
    assert variants.shape[0] > 1
    values = O.kabsch_rmsd_flips(ref, fr.ref_box(), p, box, w)
    per = values.shape[1] // variants.shape[0]
    plain = O.kabsch_rmsd(ref, fr.ref_box(), p, box, w)
    np.testing.assert_allclose(values[:, 0].numpy(), plain.numpy(), rtol=1e-6, atol=1e-7)
    # the fit of each frame against one flipped reference (frame flips off)
    com = O.refined_center(p, box, w)
    if syn.triclinic:
        u = com[:, None, :] + O.min_image(p - com[:, None, :], box)
        qc = u - ((w[None, :, None] * u).sum(1) / w.sum())[:, None, :]
        fit = torch.ones_like(w)
    else:
        half = box / 2
        qc = torch.remainder(p + (half - com)[:, None, :], box[:, None, :]) - half[:, None, :]
        fit = w
    for v in range(1, variants.shape[0]):
        want = O._kabsch(variants[v].expand(p.shape[0], -1, -1), qc, fit, w)
        np.testing.assert_allclose(values[:, v * per].numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7)
