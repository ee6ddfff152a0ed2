"""Cell lists for O(N) neighbour search (host numpy, CSR layout).

Port of `groan_rs_tpu/core/cellgrid.py` (reference:
`src/structures/cellgrid.rs:148`): orthogonal boxes only; cells at least
`cell_size` wide (box_len / floor(box_len / cell_size)); atoms binned by
their wrapped position (the port's `ops.pbc.wrap` on CPU tensors, the
float32 arithmetic of the JAX `pbc.wrap`); neighbour queries visit a
relative cell range (default -1..1 per axis) with modular wrap-around,
never visiting a cell twice.  Atoms are one CSR: the atoms sorted by
cell, stably, and per-cell offsets.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import CellGridError, GroupError, SimBoxError

__all__ = ["CellGrid", "wrap_f32"]


def wrap_f32(points, box) -> np.ndarray:
    """`points` wrapped into the orthogonal `box` in float32, as the JAX
    package's `pbc.wrap` does -> float32 numpy."""
    from ..ops import pbc

    p = torch.from_numpy(np.ascontiguousarray(points, np.float32))
    return pbc.wrap(p, torch.from_numpy(np.asarray(box, np.float32))).numpy()


def axis_offsets(ncells: int, lo: int = -1, hi: int = 2) -> list:
    """Relative offsets lo..hi-1 deduplicated modulo `ncells`, in order
    (reference: CellNeighbors::convert)."""
    out, mods = [], set()
    for d in range(lo, hi):
        m = d % ncells
        if m not in mods:
            mods.add(m)
            out.append(d)
    return out


class CellGrid:
    def __init__(self, system, group: str, cell_size: float):
        from .simbox import simbox_check

        try:
            sb = simbox_check(system.get_box())
        except SimBoxError as e:
            raise CellGridError(str(e), code="InvalidSimBox") from e
        if cell_size <= 0:
            raise CellGridError("cell size must be positive", code="InvalidCellSize")
        try:
            idx = np.asarray(system.group_indices(group))
        except GroupError as e:
            raise CellGridError(str(e), code="GroupError") from e
        if not system.has_position[idx].all():
            bad = int(idx[~system.has_position[idx]][0])
            raise CellGridError(f"atom {bad} has no position", code="InvalidPosition")

        box = sb.to_lengths_vec()
        ncells = np.maximum(np.floor(box / cell_size).astype(np.int64), 1)
        self.box = box
        self.ncells = ncells
        self.cell_size = box / ncells
        self.system = system

        coords = self._coords(wrap_f32(system.positions[idx], box))
        cell_ids = (coords[:, 0] * ncells[1] + coords[:, 1]) * ncells[2] + coords[:, 2]
        order = np.argsort(cell_ids, kind="stable")
        self.sorted_atoms = idx[order]
        total = int(ncells.prod())
        self.offsets = np.searchsorted(cell_ids[order], np.arange(total + 1))

    def _coords(self, wrapped) -> np.ndarray:
        """Cell coordinates of wrapped points (clamped: a point at L lies in
        the last cell)."""
        return np.minimum((wrapped / self.cell_size).astype(np.int64), self.ncells - 1)

    # ------------------------------------------------------------- queries
    def cell_of(self, point) -> np.ndarray:
        return self._coords(wrap_f32(point, self.box))

    def cell_atoms(self, cx: int, cy: int, cz: int) -> np.ndarray:
        cid = (cx * self.ncells[1] + cy) * self.ncells[2] + cz
        return self.sorted_atoms[self.offsets[cid]:self.offsets[cid + 1]]

    def neighbors(self, point, x_range=None, y_range=None, z_range=None) -> np.ndarray:
        """All atom indices in the neighbour cells of `point`
        (reference: neighbors_iter, cellgrid.rs:383); a range is an
        exclusive (lo, hi) of relative cell offsets, by default (-1, 2)."""
        c = self.cell_of(point)
        nx, ny, nz = (int(v) for v in self.ncells)
        offs = [axis_offsets(n, *(r or (-1, 2)))
                for n, r in ((nx, x_range), (ny, y_range), (nz, z_range))]
        parts = [self.cell_atoms((int(c[0]) + dx) % nx, (int(c[1]) + dy) % ny,
                                 (int(c[2]) + dz) % nz)
                 for dx in offs[0] for dy in offs[1] for dz in offs[2]]
        if not parts:
            return np.empty(0, np.int64)
        return np.concatenate(parts)

    def neighbors_iter(self, point, x_range=None, y_range=None, z_range=None):
        """Chainable atom iterator over `neighbors(point, ...)` (reference:
        cellgrid.rs:383, whose visit order is undefined; here atoms come in
        System order, each once)."""
        from ..system.iterating import AtomIterator

        return AtomIterator(
            self.system, np.sort(self.neighbors(point, x_range, y_range, z_range)))

    def neighbor_cell_pairs(self):
        """Yield (cell_atoms, neighbour_atoms, same_cell) for every non-empty
        cell with its half-shell of neighbour cells (each unordered cell
        pair visited once), in the JAX package's order."""
        nx, ny, nz = (int(v) for v in self.ncells)
        half = [(0, 0, 0)] + [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                              for dz in (-1, 0, 1) if (dx, dy, dz) > (0, 0, 0)]
        seen_pairs = set()
        for cx in range(nx):
            for cy in range(ny):
                for cz in range(nz):
                    a = self.cell_atoms(cx, cy, cz)
                    if a.shape[0] == 0:
                        continue
                    cid = (cx * ny + cy) * nz + cz
                    for dx, dy, dz in half:
                        ox, oy, oz = (cx + dx) % nx, (cy + dy) % ny, (cz + dz) % nz
                        oid = (ox * ny + oy) * nz + oz
                        same = (dx, dy, dz) == (0, 0, 0)
                        if not same:
                            key = (min(cid, oid), max(cid, oid))
                            if key in seen_pairs:
                                continue
                            seen_pairs.add(key)
                        b = self.cell_atoms(ox, oy, oz)
                        if b.shape[0]:
                            yield a, b, same
