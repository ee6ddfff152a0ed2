"""Backbone and side-chain dihedrals of the PyTorch port (`models.
ramachandran`, `models.chi`) against groan_rs_tpu's on the CPU.

Inputs: the 3,000-atom synthetic layout with `testing.named_layout`'s
names (30 protein residues N H CA HA CB HB1 HB2 C O HB3), 12 frames, in the
21 nm cube and in the rhombic dodecahedron; for chi, side-chain names
given to some residues' hydrogens (HB1 -> CG and HB2 -> CD on two residues
in three, HB3 -> CE on every other, H -> NZ on every fourth), so that
chi1-chi4 each cover another residue set; a chain break (chain B from
residue 16) and a gap (residue 24 renumbered 40).

Tolerances: dihedrals within 1e-3 degrees, residue numbers and names
exact, chi1 rotamer occupancies exact (no angle within 1e-3 degrees of a
well's edge, checked).  Errors raise the JAX package's class and code."""

import numpy as np
import pytest

from groan_rs_tpu import models as J

from _torch_parity import jax_system, raised, state_from_jax_system
from groan_rs_tpu_torch import convert, testing
from groan_rs_tpu_torch import models as T
from groan_rs_tpu_torch.io import native

N_ATOMS, N_FRAMES = 3000, 12
RENAMES = (("HB1", "CG", 3, (1, 2)), ("HB2", "CD", 3, (1, 2)),
           ("HB3", "CE", 2, (0,)), ("H", "NZ", 4, (0,)))


@pytest.fixture(scope="module", params=["ortho", "triclinic"])
def systems(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dih") / "named.xtc")
    tri = request.param == "triclinic"
    (testing.build_trajectory_triclinic if tri else testing.build_trajectory)(
        path, N_ATOMS, N_FRAMES)
    offs, _, _, nat = native.xtc_scan(path)
    c0, b9, *_ = native.xtc_read_frames(path, offs[:1], nat)
    state = testing.synthetic_state(c0[0], b9[0].reshape(3, 3) if tri else b9[0][[0, 4, 8]],
                                    topology="full")
    names = testing.named_layout(N_ATOMS)
    atomname = names["atomname"].astype("<U4")
    res = np.arange(N_ATOMS) // testing.RESIDUE_SIZE
    prot = np.arange(N_ATOMS) < state["groups"]["Protein"].shape[0]
    for old, new, every, keep in RENAMES:
        atomname[prot & (atomname == old) & np.isin(res % every, keep)] = new
    resnum = names["resnum"].copy()
    resnum[res == 23] = 40
    chain = np.where(prot & (res >= 15), "B", "A")
    state.update({"atomname": atomname, "resname": names["resname"],
                  "resnum": resnum, "chain": chain})
    jsys = jax_system(state)
    tsys = convert.system_from_state(state_from_jax_system(jsys, ["Protein", "Water"]),
                                     device="cpu")
    return tri, path, jsys, tsys


def test_ramachandran(systems):
    tri, path, jsys, tsys = systems
    a = J.ramachandran(jsys, path, "Protein", triclinic=tri)
    b = T.ramachandran(tsys, path, "Protein", triclinic=tri)
    assert np.array_equal(a["resids"], b["resids"])
    assert np.array_equal(a["resnames"], b["resnames"])
    assert b["phi"].shape == (N_FRAMES, 23)  # 30 less 2 ends, 2 at the chain break, 3 at the gap
    for key in ("phi", "psi"):
        assert np.abs(b[key] - a[key]).max() <= 1e-3, key


def test_chi(systems):
    tri, path, jsys, tsys = systems
    a = J.chi(jsys, path, "Protein", max_chi=4, triclinic=tri)
    b = T.chi(tsys, path, "Protein", max_chi=4, triclinic=tri)
    assert sorted(a) == sorted(b)
    for k in range(1, 5):
        nm = f"chi{k}"
        assert np.array_equal(a[f"{nm}_resids"], b[f"{nm}_resids"])
        assert np.array_equal(a[f"{nm}_resnames"], b[f"{nm}_resnames"])
        assert np.abs(b[nm] - a[nm]).max() <= 1e-3, nm
    c1 = np.abs(a["chi1"])
    assert (np.minimum(np.abs(c1 - 120), c1) > 1e-3).all()
    for well in ("g+", "t", "g-"):
        assert np.array_equal(a["rotamers"][well], b["rotamers"][well])
    assert len({len(b[f"chi{k}_resids"]) for k in range(1, 5)}) > 1


ERRORS = {
    "rama empty": lambda M, s, x: M.ramachandran(s, x, "Protein and name XYZ"),
    "rama no residue": lambda M, s, x: M.ramachandran(s, x, "Water"),
    "chi max_chi": lambda M, s, x: M.chi(s, x, "Protein", max_chi=5),
    "chi no atoms": lambda M, s, x: M.chi(s, x, "Water"),
    "chi empty": lambda M, s, x: M.chi(s, x, "Protein and name XYZ"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_match_jax(systems, case):
    _, path, jsys, tsys = systems
    want = raised(lambda: ERRORS[case](J, jsys, path))
    assert want is not None
    assert raised(lambda: ERRORS[case](T, tsys, path)) == want
