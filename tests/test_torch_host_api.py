"""The System's host API in the PyTorch port against the JAX package:
the error classes, `AtomContainer` (`empty`, `is_empty`, `isin`, `first`,
`last`, `iter`, `difference`, `add`), `SimBox.to_lengths_angles` /
`to_gro_line`, `Topology.concat`, the group splitting, extension,
membership and writability methods, `System.frame_state`, GRO
`format_atom_lines`, `xtc_probe` and `TrajectoryAnalysis.needs_velocities`.

Host numpy in both packages, so results are compared exactly (the frame
state's floats bit for bit); the named 3,000-atom System comes from
`_torch_parity.synthetic_pair(named=True)`."""

import numpy as np
import pytest

from _torch_parity import raised, synthetic_pair
from groan_rs_tpu import errors as jerr
from groan_rs_tpu.core.container import AtomContainer as JC
from groan_rs_tpu.core.simbox import SimBox as JB
from groan_rs_tpu.core.topology import Topology as JT
from groan_rs_tpu_torch import errors as terr
from groan_rs_tpu_torch.core.container import AtomContainer as TC
from groan_rs_tpu_torch.core.simbox import SimBox as TB
from groan_rs_tpu_torch.core.topology import Topology as TT


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return synthetic_pair(tmp_path_factory.mktemp("host") / "s.xtc", n_frames=2,
                          named=True)


@pytest.mark.parametrize("name", ["GuessError", "ParseTprError", "ParseYamlError",
                                  "TrajCatError"])
def test_error_classes(name):
    j, t = getattr(jerr, name), getattr(terr, name)
    assert [b.__name__ for b in t.__mro__] == [b.__name__ for b in j.__mro__]
    e = t("message", code="Code")
    assert (str(e), e.code) == ("message", "Code")
    assert t("x").code == j("x").code == name


BLOCK_SETS = [[], [3], [0, 1, 2, 7, 8, 20], list(range(5, 40, 3)), [9, 10, 11, 12]]


@pytest.mark.parametrize("a", BLOCK_SETS)
@pytest.mark.parametrize("b", BLOCK_SETS)
def test_container_algebra(a, b):
    ja, jb = JC.from_indices(a, 100), JC.from_indices(b, 100)
    ta, tb = TC.from_indices(a, 100), TC.from_indices(b, 100)
    assert np.array_equal(ta.difference(tb).blocks, ja.difference(jb).blocks)
    assert list(ta.iter()) == list(ja.iter()) == list(ta)
    assert (ta.is_empty(), ta.first(), ta.last()) == (ja.is_empty(), ja.first(), ja.last())
    for i in (-1, 0, 3, 7, 11, 20, 38, 99, 100):
        assert ta.isin(i) == ja.isin(i)
        assert np.array_equal(ta.add(i).blocks, ja.add(i).blocks) if i >= 0 else True


def test_container_empty():
    assert TC.empty().is_empty() and JC.empty().is_empty()
    assert np.array_equal(TC.empty().blocks, JC.empty().blocks)
    assert TC.empty().first() is None and TC.empty().last() is None


@pytest.mark.parametrize("lengths_angles", [
    (5.297, 4.863, 2.976, 90.0, 90.0, 90.0), (5.0, 4.0, 3.0, 80.0, 70.0, 120.0),
    (6.0, 6.0, 6.0, 60.0, 60.0, 90.0), (7.0, 7.0, 7.0, 70.528779, 109.471221, 70.528779)])
def test_simbox_lengths_angles_and_gro_line(lengths_angles):
    j, t = JB.from_lengths_angles(*lengths_angles), TB.from_lengths_angles(*lengths_angles)
    for got, want in zip(t.to_lengths_angles(), j.to_lengths_angles()):
        assert np.array_equal(got, want)
    assert t.to_gro_line() == j.to_gro_line()


def _topo(pkg_topo, n, seed, bonds):
    rng = np.random.default_rng(seed)
    t = pkg_topo(n)
    t.resnum = rng.integers(1, 5, n).astype(np.int64)
    t.atomnum = np.arange(n, dtype=np.int64) + 7
    t.mass = rng.uniform(1, 16, n).astype(np.float32)
    t.has_mass = rng.random(n) < 0.8
    t.vdw = rng.uniform(0.1, 0.2, n).astype(np.float32)
    t.has_vdw = np.ones(n, bool)
    from groan_rs_tpu.core.topology import StrColumn as JS
    from groan_rs_tpu_torch.core.topology import StrColumn as TS

    col = JS if pkg_topo is JT else TS
    t.atomname = col(values=np.asarray(rng.choice(["CA", "N", "OW", "HW1"], n), str))
    t.resname = col(values=np.asarray(rng.choice(["ALA", "SOL"], n), str))
    t.set_bonds_from_pairs(np.asarray(bonds, np.int64).reshape(-1, 2))
    return t


@pytest.mark.parametrize("sizes", [(5, 7), (4, 1, 6), (3,)])
def test_topology_concat(sizes):
    bonds = [[(0, 1), (1, 2)], [], [(0, 3), (2, 3)]]
    js = [_topo(JT, n, s, [b for b in bonds[s % 3] if max(b) < n]) for s, n in enumerate(sizes)]
    ts = [_topo(TT, n, s, [b for b in bonds[s % 3] if max(b) < n]) for s, n in enumerate(sizes)]
    j, t = JT.concat(js), TT.concat(ts)
    assert t.n_atoms == j.n_atoms
    for f in ("resnum", "atomnum", "mass", "has_mass", "vdw", "has_vdw", "charge",
              "has_charge", "expected_min_bonds", "has_expected_max_bonds"):
        assert np.array_equal(getattr(t, f), getattr(j, f), equal_nan=f in ("charge",)), f
    for f in ("resname", "atomname", "chain", "element_name", "element_symbol"):
        assert list(getattr(t, f).values()) == list(getattr(j, f).values()), f
    assert t.bonded == j.bonded
    assert np.array_equal(t.molecule_ids(), j.molecule_ids())
    assert TT.concat([]).n_atoms == JT.concat([]).n_atoms == 0


def test_group_splitting(pair):
    _, js, ts = pair
    for group in ("Protein", "Membrane"):
        for method in ("group_split_by_resid", "group_split_by_resname"):
            names = getattr(ts, method)(group)
            assert names == getattr(js, method)(group)
            for nm in names:
                assert np.array_equal(ts.group_indices(nm), js.group_indices(nm))
    for method in ("atoms_split_by_resid", "atoms_split_by_resname"):
        assert getattr(ts, method)() == getattr(js, method)()
    assert raised(lambda: ts.group_split_by_resid("Nope")) == \
        raised(lambda: js.group_split_by_resid("Nope"))


def test_group_extend_member_and_writable(pair, tmp_path):
    _, js, ts = pair
    for s in (js, ts):
        s.group_create_from_indices("A", [1, 2, 3, 100])
        s.group_create_from_indices("B", [3, 4, 2000])
        s.group_extend("A", "B")
    assert np.array_equal(ts.group_indices("A"), js.group_indices("A"))
    for i in (0, 3, 100, 2000, 2999):
        assert ts.groups_member(i) == js.groups_member(i)
    for s in (js, ts):
        s.group_make_nonwritable("A")
        s.group_make_nonwritable("Water")
        s.group_make_writable("Water")
    assert ts.group_names_writable() == js.group_names_writable()
    assert "A" not in ts.group_names_writable()
    for call in (lambda s: s.group_extend("A", "Nope"),
                 lambda s: s.group_make_writable("Nope"),
                 lambda s: s.group_make_nonwritable("Nope")):
        assert raised(lambda: call(ts)) == raised(lambda: call(js))


def test_frame_state(pair):
    _, js, ts = pair
    js.set_step(17), ts.set_step(17)
    js.set_time(3.25), ts.set_time(3.25)
    j, t = js.frame_state(), ts.frame_state()
    assert set(t) == set(j)
    for k in j:
        assert t[k].device.type == "cpu"
        assert np.asarray(j[k]).dtype == t[k].numpy().dtype, k
        assert np.array_equal(t[k].numpy(), np.asarray(j[k])), k


def test_format_atom_lines(pair):
    from groan_rs_tpu.io import gro as jgro
    from groan_rs_tpu_torch.io import gro as tgro

    _, js, ts = pair
    idx = np.r_[0:40, 1500:1520, 2990:3000]
    for vel in (False, True):
        assert tgro.format_atom_lines(ts, idx, vel) == jgro.format_atom_lines(js, idx, vel)


def test_xtc_probe(pair, tmp_path):
    from groan_rs_tpu.io import native as jn
    from groan_rs_tpu_torch.io import native as tn

    xtc = pair[0]
    assert tn.xtc_probe(xtc) == jn.xtc_probe(xtc) == (3000, 1995)
    missing = str(tmp_path / "none.xtc")
    assert raised(lambda: tn.xtc_probe(missing)) == raised(lambda: jn.xtc_probe(missing))


def test_needs_velocities(pair):
    from groan_rs_tpu.models import TrajectoryAnalysis as JA
    from groan_rs_tpu_torch.models import TrajectoryAnalysis as TA

    _, js, ts = pair
    ja, ta = JA(js).add_com("Protein"), TA(ts, device="cpu").add_com("Protein")
    assert ta.needs_velocities == ja.needs_velocities is False
    ja.add_kinetic_energy("Water")
    ta.add_kinetic_energy("Water")
    assert ta.needs_velocities == ja.needs_velocities is True
