"""The cell grid and bond guessing of the PyTorch port against the JAX
package, on systems built here: the 3,000-atom synthetic layout with real
names (`testing.named_layout`) in a 3 nm and a 21 nm box.

- `CellGrid`: grid shape, cell widths, the CSR (sorted atoms, offsets),
  `cell_of`, `neighbors` with default and wide ranges, the half-shell
  `neighbor_cell_pairs`, atoms on the box edges, and every
  `CellGridError` code; `neighbors_iter` yields JAX's atoms.
- `guess_bonds`: the same bond set and the same `GuessWarning` text after
  `guess_elements`, with the default and another radius factor; a system
  without vdw radii raises `BondGuessError`.
- The topology of one state: the JAX System and the port's give the same
  `bonded` lists in the same order (the hydrogen rows of the hydrogen-bond
  chains follow it)."""

import warnings

import numpy as np
import pytest

from groan_rs_tpu.core.cellgrid import CellGrid as JCellGrid
from groan_rs_tpu.core.simbox import SimBox as JSimBox
from groan_rs_tpu.core.topology import Topology as JTopology
from groan_rs_tpu.errors import CellGridError as JCellGridError
from groan_rs_tpu.system import System as JSystem

from _torch_parity import jax_system, state_from_jax_system
from groan_rs_tpu_torch import convert, testing
from groan_rs_tpu_torch.core.cellgrid import CellGrid as TCellGrid
from groan_rs_tpu_torch.core.simbox import SimBox as TSimBox
from groan_rs_tpu_torch.core.topology import Topology as TTopology
from groan_rs_tpu_torch.errors import CellGridError, ElementError
from groan_rs_tpu_torch.system import System as TSystem

N_ATOMS = 3000


def _positions(box_len):
    rng = np.random.default_rng(11)
    n_prot, n_mem = testing.synthetic_sizes(N_ATOMS)
    pos = rng.random((N_ATOMS, 3)).astype(np.float32) * np.float32(box_len)
    # water: O with two atoms ~0.1 nm away, as build_trajectory lays it out
    w0 = n_prot + n_mem
    oxy = np.arange(w0, N_ATOMS, 3)
    for k in (1, 2):
        h = oxy + k
        h = h[h < N_ATOMS]
        pos[h] = pos[h - k] + rng.normal(size=(h.shape[0], 3)).astype(np.float32) * 0.06
    return np.mod(pos, np.float32(box_len)).astype(np.float32)


def _named_pair(box_len):
    """(JAX System, port System) of the named layout."""
    names = testing.named_layout(N_ATOMS)
    pos = _positions(box_len)
    out = []
    for Topo, Box, Sys in ((JTopology, JSimBox, JSystem), (TTopology, TSimBox, TSystem)):
        topo = Topo.from_columns(names["resnum"], names["resname"], names["atomname"],
                                 np.arange(1, N_ATOMS + 1))
        out.append(Sys("named", topo, simbox=Box.from_lengths(box_len, box_len, box_len),
                       positions=pos.copy()))
    return out


@pytest.fixture(scope="module", params=[3.0, 21.0])
def named(request):
    js, ts = _named_pair(request.param)
    return js, ts, request.param


def _edge_pair(box_len=3.0):
    """The named pair with atoms exactly on, and just over, the box edges."""
    js, ts = _named_pair(box_len)
    for s in (js, ts):
        s.positions[0] = box_len
        s.positions[1] = 0.0
        s.positions[2] = box_len + 0.0001
        s.positions[3] = [-0.0001, box_len, 1.5]
    return js, ts


@pytest.mark.parametrize("cell", [0.35, 1.0, 1.3, 20.0])
def test_cellgrid_matches_jax(named, cell):
    js, ts, _ = named
    jg, tg = JCellGrid(js, "all", cell), TCellGrid(ts, "all", cell)
    assert np.array_equal(tg.ncells, jg.ncells)
    assert np.array_equal(tg.cell_size, np.asarray(jg.cell_size))
    assert tg.cell_size.dtype == np.asarray(jg.cell_size).dtype
    assert np.array_equal(tg.sorted_atoms, jg.sorted_atoms)
    assert np.array_equal(tg.offsets, jg.offsets)
    probes = [[0.0, 0.0, 0.0], [1.234, 2.5, 0.7], [-0.3, 25.0, 3.0], tg.box]
    for p in probes:
        assert np.array_equal(tg.cell_of(p), jg.cell_of(p))
        assert np.array_equal(tg.neighbors(p), jg.neighbors(p))
        wide = dict(x_range=(-10, 10), y_range=(-2, 1), z_range=(0, 3))
        assert np.array_equal(tg.neighbors(p, **wide), jg.neighbors(p, **wide))
    if int(np.prod(tg.ncells)) <= 1000:
        want = [(a.tolist(), b.tolist(), s) for a, b, s in jg.neighbor_cell_pairs()]
        got = [(a.tolist(), b.tolist(), s) for a, b, s in tg.neighbor_cell_pairs()]
        assert got == want


def test_cellgrid_edges_and_groups():
    js, ts = _edge_pair()
    for cell in (0.35, 1.0):
        jg, tg = JCellGrid(js, "all", cell), TCellGrid(ts, "all", cell)
        assert np.array_equal(tg.sorted_atoms, jg.sorted_atoms)
        assert np.array_equal(tg.offsets, jg.offsets)
        assert tg.offsets[-1] == N_ATOMS  # every atom in a valid cell
    for s in (js, ts):
        s.group_create_from_indices("Some", np.arange(100, 3000, 7))
    jg, tg = JCellGrid(js, "Some", 0.5), TCellGrid(ts, "Some", 0.5)
    assert np.array_equal(tg.sorted_atoms, jg.sorted_atoms)
    assert np.array_equal(tg.neighbors([1.0, 1.0, 1.0]), jg.neighbors([1.0, 1.0, 1.0]))
    got = tg.neighbors_iter([1.0, 1.0, 1.0], x_range=(-2, 2))
    want = jg.neighbors_iter([1.0, 1.0, 1.0], x_range=(-2, 2))
    assert np.array_equal(got.indices, want.indices)
    assert [a.get_index() for a in got] == [a.get_index() for a in want]


@pytest.mark.parametrize("case", ["InvalidSimBox", "InvalidCellSize", "GroupError",
                                  "InvalidPosition"])
def test_cellgrid_errors_match_jax(case):
    js, ts = _named_pair(3.0)
    codes = []
    for s, Grid, Err in ((js, JCellGrid, JCellGridError), (ts, TCellGrid, CellGridError)):
        args = {"InvalidCellSize": ("all", -1.5), "GroupError": ("Nonexistent", 1.0)}.get(
            case, ("all", 1.0))
        if case == "InvalidSimBox":
            s.set_box(None)
        if case == "InvalidPosition":
            s.has_position[7] = False
        with pytest.raises(Err) as e:
            Grid(s, *args)
        codes.append(e.value.code)
    assert codes == [case, case]


def _guessed(system, *args):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        system.guess_bonds(*args)
    return [(type(x.message).__name__, str(x.message)) for x in w]


@pytest.mark.parametrize("factor", [None, 0.7])
def test_guess_bonds_matches_jax(named, factor):
    _, _, box_len = named
    js, ts = _named_pair(box_len)
    for s in (js, ts):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s.guess_elements()
    args = () if factor is None else (factor,)
    want, got = _guessed(js, *args), _guessed(ts, *args)
    assert got == want
    jpairs = sorted((i, j) for i, nb in enumerate(js.topology.bonded) for j in nb if i < j)
    assert ts.topology.bond_pairs().tolist() == [list(p) for p in jpairs]
    assert len(jpairs) > 500
    assert ts.topology.bonded == [list(b) for b in js.topology.bonded]


def test_guess_bonds_warns_and_refuses():
    js, ts = _named_pair(3.0)
    for s in (js, ts):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s.guess_elements()
        s.topology.has_vdw[:10] = False  # atoms without vdw are skipped
    want, got = _guessed(js), _guessed(ts)
    assert got == want and "10 atom(s) without vdw" in got[0][1]
    assert ts.topology.bond_pairs().shape[0] == sum(len(b) for b in js.topology.bonded) // 2
    bare = _named_pair(3.0)[1]
    with pytest.raises(ElementError) as e:
        bare.guess_bonds()
    assert e.value.code == "BondGuessError"
    bare.guess_elements()
    bare.set_box(None)
    with pytest.raises(ElementError) as e:
        bare.guess_bonds()
    assert e.value.code == "BondGuessError"


def test_bonded_order_from_one_state(tmp_path):
    """The JAX System and the port's, built from one full-topology state,
    list each atom's bonded neighbours in the same (ascending) order."""
    xtc = str(tmp_path / "s.xtc")
    frame0, box = testing.build_trajectory(xtc, N_ATOMS, 1, box_len=3.0)
    state = testing.synthetic_state(frame0, box, topology="full")
    jsys = jax_system(state)
    tsys = convert.system_from_state(state_from_jax_system(jsys, ("Protein",)))
    direct = convert.system_from_state(state)
    want = [list(b) for b in jsys.topology.bonded]
    assert tsys.topology.bonded == want == direct.topology.bonded
    assert sum(map(len, want)) == 2 * len(state["bonds"])
