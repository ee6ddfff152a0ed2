"""Shared helpers of the `test_torch_*` parity tests: move one system's
state between the JAX package and its PyTorch port, so that both analyse
the same system.  Not a test module (no `test_` prefix)."""

from __future__ import annotations

import numpy as np
import torch

# the suite runs under several xdist workers: one intra-op thread each
torch.set_num_threads(1)


def jax_system(state: dict):
    """A `groan_rs_tpu` System built from a port state dict (as
    `bench.py:160-179` builds its System: masses and groups; a `(3, 3)`
    box through `SimBox.from_matrix`), with the
    optional charges, vdW radii, bonds, element symbols, atom names, residue numbers,
    residue names and chains set through the JAX `Topology`'s own columns
    and setters (no `resnum`: residues of three atoms, numbered from 1)."""
    from groan_rs_tpu.core.simbox import SimBox
    from groan_rs_tpu.core.topology import StrColumn, Topology
    from groan_rs_tpu.system import System

    pos = np.asarray(state["positions"], np.float32)
    n = pos.shape[0]
    topo = Topology(n)
    topo.mass = np.asarray(state["mass"], np.float32).copy()
    topo.has_mass = np.asarray(state["has_mass"], bool).copy()
    topo.atomnum = np.arange(1, n + 1, dtype=np.int64)
    topo.resnum = (np.arange(n, dtype=np.int64) // 3 + 1
                   if state.get("resnum") is None
                   else np.asarray(state["resnum"], np.int64).copy())
    if state.get("charge") is not None:
        topo.charge = np.asarray(state["charge"], np.float32).copy()
        topo.has_charge = np.asarray(state["has_charge"], bool).copy()
    if state.get("vdw") is not None:
        topo.vdw = np.asarray(state["vdw"], np.float32).copy()
        topo.has_vdw = np.asarray(state["has_vdw"], bool).copy()
    if state.get("element") is not None:
        topo.element_symbol = StrColumn(values=np.asarray(state["element"], str))
    for key in ("atomname", "resname", "chain"):
        if state.get(key) is not None:
            setattr(topo, key, StrColumn(values=np.asarray(state[key], str)))
    if state.get("bonds") is not None:
        topo.set_bonds_from_pairs(np.asarray(state["bonds"], np.int64))
    box = np.asarray(state["box"], np.float32)
    simbox = (SimBox.from_matrix(box) if box.shape == (3, 3)
              else SimBox.from_lengths(*map(float, box)))
    s = System(state.get("name", "system"), topo, simbox=simbox, positions=pos)
    s.set_precision(int(state["precision"]))
    for name, idx in state["groups"].items():
        idx = np.asarray(idx)
        if idx.shape[0] and idx[-1] - idx[0] == idx.shape[0] - 1:
            s.group_create_from_ranges(name, [(int(idx[0]), int(idx[-1]))])
        else:
            s.group_create_from_indices(name, idx)
    return s


def _strs(col):
    """A JAX `StrColumn` as a per-atom str array (None when it was never
    set: no categories)."""
    return np.asarray(col.values(), str) if len(col.categories) else None


def state_from_jax_system(system, groups) -> dict:
    """The state dict (`groan_rs_tpu_torch.convert`) of a `groan_rs_tpu`
    System, carrying the named groups, charges, vdW radii, bonds, element symbols,
    atom names and the residue columns; a triclinic box as its `(3, 3)`
    matrix."""
    topo = system.topology
    box = system.get_box()
    pairs = [(i, j) for i, nb in enumerate(topo.bonded) for j in nb if i <= j]
    return {
        "name": system.name,
        "positions": np.asarray(system.positions, np.float32),
        "box": (np.asarray(box.to_lengths_vec(), np.float32)
                if box.is_orthogonal() else box.to_matrix()),
        "mass": np.asarray(topo.mass, np.float32),
        "has_mass": np.asarray(topo.has_mass, bool),
        "charge": np.asarray(topo.charge, np.float32),
        "has_charge": np.asarray(topo.has_charge, bool),
        "vdw": np.asarray(topo.vdw, np.float32),
        "has_vdw": np.asarray(topo.has_vdw, bool),
        "bonds": np.asarray(pairs, np.int64).reshape(-1, 2),
        "element": _strs(topo.element_symbol),
        "atomname": _strs(topo.atomname),
        "resnum": np.asarray(topo.resnum, np.int64),
        "resname": _strs(topo.resname),
        "chain": _strs(topo.chain),
        "precision": int(system.precision),
        "groups": {g: np.asarray(system.group_indices(g)) for g in groups},
    }


def t(x):
    """numpy -> CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(x))


def n(x):
    """tensor / jax array -> numpy."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def synthetic_pair(path, n_atoms: int = 3000, n_frames: int = 12,
                   groups=("Protein", "Membrane", "Peptide", "Water"),
                   named: bool = False, triclinic: bool = False):
    """(XTC path, JAX System, port System on the CPU) of the synthetic
    layout with the full topology (charges, bonds, elements, names) at
    frame 0 of a trajectory written to `path`; the state carries the JAX
    System's residue numbers to the port System.  `named=True` gives the
    atoms the residue and atom names of `testing.named_layout` (protein
    residues N H CA HA CB HB1 HB2 C O HB3); `triclinic=True` writes the
    rhombic-dodecahedron trajectory (`testing.build_trajectory_triclinic`)."""
    from groan_rs_tpu_torch import convert, testing
    from groan_rs_tpu_torch.io import native

    build = testing.build_trajectory_triclinic if triclinic else testing.build_trajectory
    build(str(path), n_atoms, n_frames)
    offs, _, _, nat = native.xtc_scan(str(path))
    c0, b9, *_ = native.xtc_read_frames(str(path), offs[:1], nat)
    box = b9[0].reshape(3, 3) if triclinic else b9[0][[0, 4, 8]]
    state = testing.synthetic_state(c0[0], box, topology="full")
    if named:
        names = testing.named_layout(n_atoms)
        state.update({k: names[k] for k in ("resnum", "resname", "atomname")})
    jsys = jax_system(state)
    tsys = convert.system_from_state(state_from_jax_system(jsys, groups), device="cpu")
    tsys.topology.atomnum = jsys.topology.atomnum.copy()
    return str(path), jsys, tsys


def raised(fn):
    """(exception class name, its `code`) of what `fn()` raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__, getattr(e, "code", None)
    return None


def named_pairs(tmp_path_factory, n_frames: int = 12):
    """{"ortho": ..., "triclinic": ...} of `synthetic_pair(named=True)`
    triples at 3,000 atoms, each System with the group CA (the protein's
    30 alpha carbons)."""
    out = {}
    for form in ("ortho", "triclinic"):
        path = tmp_path_factory.mktemp(form) / "named.xtc"
        xtc, js, ts = synthetic_pair(path, n_frames=n_frames, named=True,
                                     triclinic=form == "triclinic")
        for s in (js, ts):
            s.group_create("CA", "Protein and name CA")
        out[form] = (xtc, js, ts)
    return out


def frames_pair(path, frames, box, groups, *, boxes=None, precision=100000,
                **columns):
    """(XTC path, JAX System, port System on the CPU) of hand-built frames
    `[F, N, 3]` written to `path`: `box` the System's box ((3,) lengths or
    a (3, 3) matrix), `boxes` optional per-frame `[F, 3]` lengths for the
    file, `groups` {name: indices}; `columns` the optional state columns
    (mass, charge, atomname, resnum, resname)."""
    from groan_rs_tpu_torch.io import native

    frames = np.asarray(frames, np.float32)
    f, n = frames.shape[:2]
    box = np.asarray(box, np.float32)
    for i in range(f):
        b9 = (box.reshape(9) if box.shape == (3, 3) else
              np.diag(box if boxes is None else np.asarray(boxes, np.float32)[i]).reshape(9))
        native.xtc_write_frame(str(path), n, i, float(i), b9, frames[i], float(precision))
    state = {"positions": frames[0], "box": box, "precision": precision,
             "mass": np.ones(n, np.float32), "has_mass": np.ones(n, bool),
             "groups": {k: np.asarray(v, np.int64) for k, v in groups.items()}}
    for key, val in columns.items():
        state[key] = np.asarray(val)
    for key in ("charge", "vdw"):
        if key in columns:
            state["has_" + key] = np.ones(n, bool)
    jsys = jax_system(state)
    from groan_rs_tpu_torch import convert

    tsys = convert.system_from_state(state_from_jax_system(jsys, groups), device="cpu")
    tsys.topology.atomnum = jsys.topology.atomnum.copy()
    return str(path), jsys, tsys


def geometry_pairs(tmp_path_factory, n_frames: int = 6):
    """{"ortho": ..., "triclinic": ...} of `synthetic_pair(named=True)`
    triples at 3,000 atoms for the geometric analyses: seeded vdW radii
    (0.10-0.18 nm) on every atom and the groups CA (the protein's alpha
    carbons) and WW (the whole three-site waters)."""
    out = {}
    radii = np.random.default_rng(3).uniform(0.1, 0.18, 3000).astype(np.float32)
    for form in ("ortho", "triclinic"):
        path = tmp_path_factory.mktemp(form) / "geom.xtc"
        xtc, js, ts = synthetic_pair(path, n_frames=n_frames, named=True,
                                     triclinic=form == "triclinic")
        for s in (js, ts):
            s.topology.vdw = radii.copy()
            s.topology.has_vdw = np.ones(radii.shape[0], bool)
            s.group_create("CA", "Protein and name CA")
            w = s.group_indices("Water")
            s.group_create_from_indices("WW", w[:3 * (w.shape[0] // 3)])
        out[form] = (xtc, js, ts)
    return out
