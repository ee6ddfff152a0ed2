"""Secondary structure in the PyTorch port (`ops/dssp.py`,
`models.dssp`) against groan_rs_tpu's on the CPU, and the residue columns
that carry a System across the two packages.

Inputs: a 40-residue ideal alpha helix (chain A) and an ideal beta
hairpin of two 11-residue strands whose turn is left out (chain B, a gap
of 2 in the residue numbers), `testing.backbone_state`, over 8 frames
with seeded Gaussian noise of 0.01 nm per coordinate, in a 12 nm cube and
in a rhombic dodecahedron; every fourth residue of the hairpin a proline
in one case; the 30 random-blob residues of the named 3,000-atom layout.

Tolerances: finite energies within 1e-4 kcal/mol of JAX's and +inf at the
same pairs; 3- and 8-state codes exact on every frame with no energy
within 1e-4 kcal/mol of the cutoff (the frames counted); the pattern
algebra exact on seeded random hydrogen-bond matrices with chain breaks;
the ideal structures read H inside the helix and E along the strands."""

import numpy as np
import pytest
import torch

from groan_rs_tpu import models as J
from groan_rs_tpu.ops import dssp as jdssp

from _torch_parity import jax_system, named_pairs, raised, state_from_jax_system
from groan_rs_tpu_torch import convert, testing
from groan_rs_tpu_torch import models as T
from groan_rs_tpu_torch.io import native
from groan_rs_tpu_torch.ops import dssp as tdssp

N_HELIX, N_STRAND, N_FRAMES, BOX = 40, 11, 8, 12.0


def _state(proline=False):
    state = testing.backbone_state(
        [(testing.ideal_backbone(N_HELIX, *testing.HELIX_PHI_PSI), "A", 0),
         (testing.ideal_hairpin(N_STRAND), "B", N_STRAND)], BOX)
    if proline:
        res = state["resname"].copy()
        chain_b = state["chain"] == "B"
        res[chain_b & (state["resnum"] % 4 == 0)] = "PRO"
        state["resname"] = res
    return state


@pytest.fixture(scope="module", params=["ortho", "triclinic", "proline"])
def backbones(request, tmp_path_factory):
    state = _state(proline=request.param == "proline")
    box9 = (testing.dodecahedron(BOX) if request.param == "triclinic"
            else np.diag(np.full(3, BOX, np.float32))).reshape(9)
    if request.param == "triclinic":
        state["box"] = box9.reshape(3, 3)
    path = str(tmp_path_factory.mktemp("bb") / "backbone.xtc")
    rng = np.random.default_rng(17)
    for f in range(N_FRAMES):
        noisy = state["positions"] + (rng.normal(size=state["positions"].shape)
                                      * 0.01 * (f > 0)).astype(np.float32)
        native.xtc_write_frame(path, len(noisy), f, float(f), box9, noisy, 10000.0)
    jsys = jax_system(state)
    tsys = convert.system_from_state(
        state_from_jax_system(jsys, ["Backbone", "chainA", "chainB"]), device="cpu")
    return request.param, path, jsys, tsys


def _clean_frames(jsys, path, group):
    """Frames with no JAX energy within 1e-4 kcal/mol of the cutoff."""
    from groan_rs_tpu.models.pipeline import _resident_group_pos

    _, pos, boxes, _ = _resident_group_pos(jsys, path, group, 32)
    pos = np.asarray(pos).reshape(pos.shape[0], -1, 4, 3)
    r = pos.shape[1]
    e = np.asarray(jdssp.hbond_energy(pos[:, :, 0], pos[:, :, 1], pos[:, :, 2],
                                      pos[:, :, 3], boxes, np.ones(r, bool)))
    return ~(np.abs(e - jdssp.KS_CUTOFF) < 1e-4).any((1, 2))


@pytest.mark.parametrize("states", [3, 8])
def test_dssp_codes(backbones, states):
    form, path, jsys, tsys = backbones
    a = J.dssp(jsys, path, "Backbone", states=states)
    b = T.dssp(tsys, path, "Backbone", states=states)
    assert np.array_equal(a["resids"], b["resids"])
    assert np.array_equal(a["resnames"], b["resnames"])
    clean = _clean_frames(jsys, path, "Backbone")
    assert clean.sum() >= N_FRAMES - 1
    assert np.array_equal(a["ss"][clean], b["ss"][clean])
    assert b["ss"].shape == (N_FRAMES, N_HELIX + 2 * N_STRAND)
    assert set(b["frac"]) == set(a["frac"])


@pytest.mark.parametrize("states", [3, 8])
def test_ideal_structures(backbones, states):
    """Frame 0 is the ideal geometry: H inside the helix, E along the
    strands but their ends and the pair next to the left-out turn."""
    form, path, _, tsys = backbones
    ss = T.dssp(tsys, path, "Backbone", states=states)["ss"][0]
    helix, hairpin = ss[:N_HELIX], ss[N_HELIX:]
    assert (helix[3:N_HELIX - 1] == "H").all(), "".join(helix)
    if form != "proline":
        s = N_STRAND
        assert (hairpin[1:s - 2] == "E").all() and (hairpin[s + 2:-1] == "E").all(), \
            "".join(hairpin)


def test_energies(backbones):
    form, path, jsys, _ = backbones
    from groan_rs_tpu.models.pipeline import _resident_group_pos

    _, pos, boxes, _ = _resident_group_pos(jsys, path, "Backbone", 32)
    pos = np.array(pos).reshape(N_FRAMES, -1, 4, 3)
    boxes = np.array(boxes)
    r = pos.shape[1]
    ok = np.random.default_rng(1).uniform(size=r) > 0.2
    want = np.asarray(jdssp.hbond_energy(*(pos[:, :, k] for k in range(4)), boxes, ok))
    got = tdssp.hbond_energy(*(torch.from_numpy(pos[:, :, k].copy()) for k in range(4)),
                             torch.from_numpy(boxes), ok).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got)) and (want[~fin] == got[~fin]).all()
    assert np.abs(got[fin] - want[fin]).max() <= 1e-4
    assert (want[fin] < jdssp.KS_CUTOFF).sum() > 20


def test_dssp_random_residues(tmp_path_factory):
    """The 30 ten-atom residues of the named layout (random geometry; every
    name cycles through the amino acids, prolines included)."""
    pairs = named_pairs(tmp_path_factory)
    for form, (xtc, js, ts) in pairs.items():
        for states in (3, 8):
            a = J.dssp(js, xtc, "Protein", states=states)
            b = T.dssp(ts, xtc, "Protein", states=states)
            assert np.array_equal(a["ss"], b["ss"]), (form, states)
            assert "PRO" in b["resnames"]


@pytest.mark.parametrize("seed", range(4))
def test_pattern_algebra(seed):
    rng = np.random.default_rng(seed)
    f, r = 3, 30
    e = np.where(rng.uniform(size=(f, r, r)) < 0.12, -1.5, 0.0)
    consec = rng.uniform(size=r) > 0.1
    ca = rng.normal(size=(f, r, 3)).astype(np.float32)
    boxes = np.full((f, 3), 50.0, np.float32)
    assert np.array_equal(tdssp.assign_3state(torch.from_numpy(e), consec),
                          jdssp.assign_3state(e, consec))
    assert np.array_equal(
        tdssp.assign_8state(torch.from_numpy(e), consec, ca=ca, boxes=boxes),
        jdssp.assign_8state(e, consec, ca=ca, boxes=boxes))
    assert np.array_equal(tdssp.assign_8state(torch.from_numpy(e), consec),
                          jdssp.assign_8state(e, consec))


@pytest.mark.parametrize("states", [3, 8])
def test_chunked_codes(states, monkeypatch):
    """Frame chunks of the energies do not change the codes."""
    state = _state()
    xyz = torch.from_numpy(state["positions"]).reshape(1, -1, 4, 3)
    xyz = xyz + torch.from_numpy(np.random.default_rng(2).normal(
        size=(5,) + xyz.shape[1:]).astype(np.float32) * 0.02)
    r = xyz.shape[1]
    args = [xyz[:, :, k] for k in range(4)] + [torch.full((5, 3), BOX),
                                               np.ones(r, bool), np.ones(r, bool)]
    whole = tdssp.codes(*args, states=states)
    monkeypatch.setattr(tdssp, "_CHUNK_PAIRS", r * r)
    assert np.array_equal(tdssp.codes(*args, states=states), whole)


def test_state_carries_residues():
    """Residue numbers, residue names and chains go both ways through the
    state dict; a state without them loads with residue 0 and no names."""
    names = testing.named_layout(3000)
    state = testing.synthetic_state(np.zeros((3000, 3), np.float32),
                                    np.full(3, 5.0, np.float32), topology="full")
    state.update({k: names[k] for k in ("resnum", "resname", "atomname")})
    state["chain"] = np.where(np.arange(3000) < 300, "P", "")
    jsys = jax_system(state)
    back = state_from_jax_system(jsys, ["Protein"])
    tsys = convert.system_from_state(back, device="cpu")
    for key in ("resnum", "resname", "atomname", "chain"):
        assert np.array_equal(back[key], state[key]), key
        col = getattr(tsys.topology, key)
        got = col if key == "resnum" else np.asarray(col.values(), str)
        assert np.array_equal(got, state[key]), key
    bare = {k: v for k, v in back.items() if k not in ("resnum", "resname", "chain")}
    plain = convert.system_from_state(bare, device="cpu").topology
    assert (plain.resnum == 0).all() and set(plain.resname.values()) == {""}


def test_errors_match_jax(tmp_path):
    state = _state()
    path = str(tmp_path / "frame0.xtc")
    native.xtc_write_frame(path, len(state["positions"]), 0, 0.0,
                           np.diag(np.full(3, BOX, np.float32)).reshape(9),
                           state["positions"], 10000.0)
    jsys = jax_system(state)
    tsys = convert.system_from_state(state_from_jax_system(jsys, ["Backbone"]),
                                     device="cpu")
    for s in (jsys, tsys):
        s.group_create_from_indices("Four", np.arange(16))
        s.group_create_from_indices("NoO", np.flatnonzero(np.arange(40 * 4) % 4 != 3))
    for call in (lambda M, s: M.dssp(s, path, "Backbone", states=4),
                 lambda M, s: M.dssp(s, path, "Four"),
                 lambda M, s: M.dssp(s, path, "NoO"),
                 lambda M, s: M.dssp(s, path, "Nowhere")):
        want = raised(lambda: call(J, jsys))
        assert want is not None
        assert raised(lambda: call(T, tsys)) == want


def test_host_oracles_match_jax():
    """The float64 oracles of `chip_smoke.py` phase 13 against the JAX
    package's functions: energies (a donor band and an acceptor band)
    within 1e-4 kcal/mol, codes exact on random hydrogen-bond matrices."""
    state = _state()
    xyz = state["positions"].reshape(-1, 4, 3) + np.random.default_rng(5).normal(
        size=(N_HELIX + 2 * N_STRAND, 4, 3)).astype(np.float32) * 0.02
    r = xyz.shape[0]
    ok = np.ones(r, bool)
    ok[[0, 7]] = False
    box = np.full(3, BOX, np.float32)
    want = np.asarray(jdssp.hbond_energy(*(xyz[None, :, k] for k in range(4)), box[None], ok))[0]
    band = np.arange(10, 30)
    for got, ref in ((testing.host_dssp_energy(*(xyz[:, k] for k in range(4)), box, ok,
                                               rows=band), want[band]),
                     (testing.host_dssp_energy(*(xyz[:, k] for k in range(4)), box, ok,
                                               cols=band), want[:, band])):
        fin = np.isfinite(ref)
        assert np.array_equal(fin, np.isfinite(got))
        assert np.abs(got[fin] - ref[fin]).max() <= 1e-4
    rng = np.random.default_rng(11)
    for _ in range(10):
        hb = rng.uniform(size=(r, r)) < 0.1
        consec = rng.uniform(size=r) > 0.1
        ca = rng.normal(size=(r, 3)).astype(np.float32)
        e = np.where(hb, -1.0, 0.0)[None]
        assert np.array_equal(testing.host_dssp_codes(hb, consec, 3),
                              jdssp.assign_3state(e, consec)[0])
        assert np.array_equal(testing.host_dssp_codes(hb, consec, 8, ca, box),
                              jdssp.assign_8state(e, consec, ca=ca[None], boxes=box[None])[0])


def test_five_residues():
    """Five residues, the least `dssp` accepts: the port's codes are
    defined; the JAX pattern algebra raises a numpy broadcast error there
    (its 5-helix span; ROADMAP.md section 3 records the gap)."""
    e = np.zeros((1, 5, 5))
    for k in range(3):
        e[0, k + 2, k] = -1.0                   # 2-residue contacts only
    for fn in (jdssp.assign_3state, jdssp.assign_8state):
        with pytest.raises(ValueError):
            fn(e, np.ones(5, bool))
    assert np.array_equal(tdssp.assign_3state(torch.from_numpy(e), np.ones(5, bool)),
                          np.full((1, 5), "-"))
    assert tdssp.assign_8state(torch.from_numpy(e), np.ones(5, bool)).shape == (1, 5)
