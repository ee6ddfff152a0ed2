"""Move a system's state across packages as plain numpy.

The state dict is what weights are to a model: everything the analysis
reads from a System.  Keys:

- `positions`  float32 `[N, 3]` reference coordinates
- `box`        float32 `(3,)` orthorhombic lengths or `(3, 3)` box matrix
               (rows are the box vectors)
- `mass`       float32 `[N]`;  `has_mass` bool `[N]`
- `precision`  int (XTC precision of the reference frame)
- `groups`     `{name: sorted int indices}`
- `name`       optional system name

Optional (a state without them loads with no charges, no bonds, no
names and every atom in residue 0):

- `charge`     float32 `[N]`;  `has_charge` bool `[N]`
- `vdw`        float32 `[N]` vdW radii (nm);  `has_vdw` bool `[N]`
- `bonds`      int `[K, 2]` bonded atom pairs
- `element`    str `[N]` element symbols ('' = not set)
- `atomname`   str `[N]` atom names
- `resnum`     int `[N]` residue numbers (default 0)
- `resname`    str `[N]` residue names
- `chain`      str `[N]` chain identifiers ('' = no chain)
"""

from __future__ import annotations

import numpy as np

from .core.simbox import SimBox
from .core.topology import Topology
from .system import System

__all__ = ["system_from_state"]


def system_from_state(state: dict, device=None) -> System:
    """The System of a state dict; `device` as for `System` (None: the
    CUDA card, resolved at the first call that computes)."""
    pos = np.asarray(state["positions"], np.float32)
    n = pos.shape[0]
    topo = Topology(n)
    topo.mass = np.asarray(state["mass"], np.float32).reshape(n).copy()
    topo.has_mass = np.asarray(state["has_mass"], bool).reshape(n).copy()
    if state.get("charge") is not None:
        topo.charge = np.asarray(state["charge"], np.float32).reshape(n).copy()
        topo.has_charge = np.asarray(
            state.get("has_charge", ~np.isnan(topo.charge)), bool).reshape(n).copy()
    if state.get("vdw") is not None:
        topo.vdw = np.asarray(state["vdw"], np.float32).reshape(n).copy()
        topo.has_vdw = np.asarray(
            state.get("has_vdw", ~np.isnan(topo.vdw)), bool).reshape(n).copy()
    for key in ("element", "atomname", "resname", "chain"):
        if state.get(key) is not None:
            setattr(topo, "element_symbol" if key == "element" else key,
                    np.asarray(state[key], str).reshape(n).copy())
    if state.get("resnum") is not None:
        topo.resnum = np.asarray(state["resnum"], np.int64).reshape(n).copy()
    if state.get("bonds") is not None:
        topo.set_bonds_from_pairs(state["bonds"])
    box = np.asarray(state["box"], np.float32)
    simbox = (SimBox.from_matrix(box) if box.shape == (3, 3)
              else SimBox.from_lengths(*map(float, box.reshape(3))))
    s = System(state.get("name", "system"), topo, simbox=simbox, positions=pos,
               device=device)
    s.set_precision(int(state.get("precision", 100)))
    for name, idx in state.get("groups", {}).items():
        s.group_create_from_indices(name, idx)
    return s
