"""The System's modifying and RMSD methods, and the trajectory RMSD
iterator, of the PyTorch port against the JAX System on the 3,000-atom
synthetic system (full topology: bonded lipids and waters, many broken
across the box) and its 12-frame XTC, on the CPU.

Tolerances: positions 1e-5 nm, renumbering and bonds exact; RMSD 1e-5,
rotations 1e-5, fitted positions 1e-4.  On the refine tie sets
(`testing.refine_tie_sets`: d = (p - e) + L/2 at k L exactly) the
make-whole unwrap and the fit's wrap pick the JAX package's images, bit
for bit (but for subnormal coordinates, which XLA's CPU flushes to
zero)."""

import numpy as np
import pytest
import torch

from groan_rs_tpu.core.dimension import Dimension as JDim
from groan_rs_tpu.errors import GroanError as JGroanError
from groan_rs_tpu.ops import pbc as jpbc
from groan_rs_tpu.ops import rmsd as jrmsd

from _torch_parity import synthetic_pair
from groan_rs_tpu_torch import testing
from groan_rs_tpu_torch.core.dimension import Dimension as TDim
from groan_rs_tpu_torch.errors import GroanError
from groan_rs_tpu_torch.ops import kernels as K
from groan_rs_tpu_torch.ops import pbc as tpbc
from groan_rs_tpu_torch.ops import rmsd as trmsd


@pytest.fixture(scope="module")
def triple(tmp_path_factory):
    return synthetic_pair(tmp_path_factory.mktemp("modify") / "synthetic.xtc")


@pytest.fixture
def fresh(triple):
    _, js, ts = triple
    return js.copy(), ts.copy()


MODIFY = {
    "group_translate": lambda s, D: s.group_translate("Protein", [3.1, -7.25, 20.0]),
    "atoms_translate": lambda s, D: s.atoms_translate([-0.5, 10.5, 0.25]),
    "atoms_translate_nopbc": lambda s, D: s.atoms_translate_nopbc([1.0, 2.0, -30.0]),
    "atoms_wrap": lambda s, D: (s.atoms_translate_nopbc([15.0, -22.0, 40.0]),
                                s.atoms_wrap()),
    "group_wrap": lambda s, D: (s.atoms_translate_nopbc([-15.0, 22.0, 4.0]),
                                s.group_wrap("Membrane")),
    "make_molecules_whole": lambda s, D: s.make_molecules_whole(),
    "make_group_whole": lambda s, D: s.make_group_whole("Membrane"),
    "make_group_whole_protein": lambda s, D: s.make_group_whole("Protein"),
}


@pytest.mark.parametrize("name", sorted(MODIFY))
def test_positions_match_jax(fresh, name):
    js, ts = fresh
    MODIFY[name](js, JDim)
    MODIFY[name](ts, TDim)
    assert ts.positions.dtype == np.float32
    np.testing.assert_allclose(ts.positions, js.positions, rtol=0, atol=1e-5)
    assert np.array_equal(ts.has_position, js.has_position)


def test_make_molecules_whole_makes_molecules_whole(fresh):
    """Every bond is shorter than half the box after the call (the layout
    has bonds split across the box before it)."""
    _, ts = fresh
    bonds = ts.topology.bond_pairs()
    d = np.abs(ts.positions[bonds[:, 0]] - ts.positions[bonds[:, 1]])
    assert (d > 10.0).any()
    ts.make_molecules_whole()
    d = np.abs(ts.positions[bonds[:, 0]] - ts.positions[bonds[:, 1]])
    assert (d < 1.0).all()


def test_renumbering_and_bonds_match_jax(fresh):
    js, ts = fresh
    for s in (js, ts):
        s.topology.resnum[:] = np.repeat([5, 0, 9, 9, 2], 600)
        s.topology.atomnum[:] = 7
        s.residues_renumber()
        s.atoms_renumber()
    assert np.array_equal(ts.topology.resnum, js.topology.resnum)
    assert np.array_equal(ts.topology.atomnum, js.topology.atomnum)
    assert ts.has_bonds() and js.has_bonds()
    for s in (js, ts):
        s.clear_bonds()
        s.add_bond(3, 1)
        s.add_bond(1, 3)
        s.add_bond(1, 2999)
    assert [list(b) for b in ts.topology.bonded[:4]] == js.topology.bonded[:4]
    assert np.array_equal(ts.get_mol_references(), js.get_mol_references())
    for s, err in ((js, JGroanError), (ts, GroanError)):
        with pytest.raises(err) as e:
            s.add_bond(4, 4)
        assert e.value.code == "SelfBonding"


@pytest.mark.parametrize("case", ["translate-no-box", "wrap-group-no-box",
                                  "whole-no-position", "group-whole-no-position"])
def test_modify_errors_match_jax(fresh, case):
    js, ts = fresh
    for s in (js, ts):
        if "no-box" in case:
            s.set_box(None)
        else:
            s.has_position[11] = False
    call = {"translate-no-box": lambda s: s.atoms_translate([1, 1, 1]),
            "wrap-group-no-box": lambda s: s.group_wrap("Protein"),
            "whole-no-position": lambda s: s.make_molecules_whole(),
            "group-whole-no-position": lambda s: s.make_group_whole("Protein")}[case]
    with pytest.raises(JGroanError) as je:
        call(js)
    with pytest.raises(GroanError) as te:
        call(ts)
    assert (type(te.value).__name__, te.value.code) == (type(je.value).__name__, je.value.code)


@pytest.mark.parametrize("frame", range(12))
def test_equal_images_go_the_jax_way(fresh, frame, monkeypatch):
    """make_group_whole around a fixed estimate, and fit_transform around
    a fixed COM, on the refine tie sets: equal bits."""
    js, ts = fresh
    pos, est, box = (x[frame] for x in testing.refine_tie_sets())
    n = pos.shape[0]
    for s in (js, ts):
        s.group_create_from_indices("Ties", np.arange(n))
        s.positions[:n] = pos
        s.simbox.v1x, s.simbox.v2y, s.simbox.v3z = map(float, box)
        monkeypatch.setattr(type(s), "group_estimate_center",
                            lambda self, name, e=est: e.copy())
        s.make_group_whole("Ties")
    assert np.array_equal(ts.positions[:n], js.positions[:n])
    rot = np.eye(3, dtype=np.float32)
    want = np.asarray(jrmsd.fit_transform(pos, box, est, rot, est))
    got = trmsd.fit_transform(torch.from_numpy(pos), torch.from_numpy(box),
                              torch.from_numpy(est), torch.from_numpy(rot),
                              torch.from_numpy(est)).numpy()
    # XLA's CPU flushes subnormal inputs to zero, torch (and the
    # reference's float32) does not: a coordinate of -4e-45 wraps to L in
    # the port and to 0 in the JAX package; such atoms are left out
    normal = ((pos == 0) | (np.abs(pos) >= np.finfo(np.float32).tiny)).all(1)
    assert normal.sum() > n // 2
    assert np.array_equal(got[normal], want[normal])
    vt = tpbc.vector_to(torch.from_numpy(est), torch.from_numpy(pos),
                        torch.from_numpy(box)).numpy()
    assert np.array_equal(vt, np.asarray(jpbc.vector_to(est, pos, box)))


def _frame(system, xtc, k):
    """`system` holding frame k of `xtc`."""
    for i, s in enumerate(system.xtc_iter(xtc)):
        if i == k:
            return s
    raise AssertionError(k)


@pytest.mark.parametrize("group", ["Protein", "Membrane"])
def test_calc_rmsd_matches_jax(triple, group):
    xtc, js0, ts0 = triple
    js, ts = _frame(js0.copy(), xtc, 7), _frame(ts0.copy(), xtc, 7)
    jr, jt, jrms = js.calc_rmsd_rot_trans(js0, group)
    tr, tt, trms = ts.calc_rmsd_rot_trans(ts0, group)
    assert abs(trms - jrms) < 1e-5 and trms > 1e-3
    np.testing.assert_allclose(tr, np.asarray(jr), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt, np.asarray(jt), rtol=0, atol=1e-5)
    assert abs(ts.calc_rmsd(ts0, group) - js.calc_rmsd(js0, group)) < 1e-5
    jfit = js.calc_rmsd_and_fit(js0, group)
    tfit = ts.calc_rmsd_and_fit(ts0, group)
    assert abs(tfit - jfit) < 1e-5
    np.testing.assert_allclose(ts.positions, js.positions, rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", ["NonexistentGroup", "EmptyGroup", "InvalidSimBox",
                                  "InconsistentGroup", "InvalidMass", "PartialRead"])
def test_rmsd_errors_match_jax(triple, case):
    xtc, js0, ts0 = triple
    codes = []
    for s0, err in ((js0, JGroanError), (ts0, GroanError)):
        ref, s = s0.copy(), s0.copy()
        s.group_create_from_indices("Empty", [])
        s.group_create_from_indices("Few", [1, 2, 3])
        ref.group_create_from_indices("Few", [1, 2])
        call = {"NonexistentGroup": lambda: s.calc_rmsd(ref, "Nope"),
                "EmptyGroup": lambda: s.calc_rmsd(s, "Empty"),
                "InvalidSimBox": lambda: (s.set_box(None), s.calc_rmsd(ref, "Protein")),
                "InconsistentGroup": lambda: s.calc_rmsd(ref, "Few"),
                "InvalidMass": lambda: (ref.topology.has_mass.__setitem__(1, False),
                                        s.calc_rmsd(ref, "Protein")),
                "PartialRead": lambda: s.xtc_iter(xtc, group="Protein").calc_rmsd(
                    ref, "Protein")}[case]
        with pytest.raises(err) as e:
            call()
        codes.append(e.value.code)
    assert codes[0] == codes[1] == case


@pytest.mark.parametrize("fit", [False, True])
@pytest.mark.parametrize("batch_size", [5, 64])
def test_rmsd_iterator_matches_jax(triple, fit, batch_size):
    """The per-batch device iterator against the JAX per-frame path: the
    RMSD series, every frame's System (fitted when fitting), time and
    step; one K1 + K2 pair per batch (none on the CPU)."""
    xtc, js0, ts0 = triple
    js, ts = js0.copy(), ts0.copy()
    method = "calc_rmsd_and_fit" if fit else "calc_rmsd"
    jit = getattr(js.xtc_iter(xtc, batch_size=batch_size), method)(js0, "Protein")
    tit = getattr(ts.xtc_iter(xtc, batch_size=batch_size), method)(ts0, "Protein")
    K.reset_launch_counts()
    n = 0
    for (jf, jr), (tf, tr) in zip(jit, tit):
        assert tf is ts
        assert abs(tr - jr) < 1e-5
        assert (tf.get_time(), tf.get_step()) == (jf.get_time(), jf.get_step())
        np.testing.assert_allclose(tf.positions, jf.positions, rtol=0, atol=1e-4)
        n += 1
    assert n == 12
    assert all(v == 0 for v in K.launch_counts.values())
