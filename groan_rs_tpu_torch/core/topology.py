"""Per-atom topology columns and the bond graph.

The slice of `groan_rs_tpu.core.topology.Topology` (`:101-265`) that the
ported observables read:

- `mass` / `has_mass`, `charge` / `has_charge` (float32 with presence
  masks);
- `element_symbol` and `atomname` as plain per-atom string arrays ('' =
  not set; the port needs no interned `StrColumn`);
- bonds: `add_bond`, `set_bonds_from_pairs`, the sorted adjacency lists
  `bonded`, its CSR form `bonds_csr` and `molecule_ids`.

Bonds are held as one deduplicated `[K, 2]` pair array; the CSR and the
molecule ids are built from it with numpy and scipy's connected
components (no per-atom Python loop: at 1M atoms the JAX package's BFS
costs seconds of host time).  Molecule ids are ordered by each
molecule's first atom, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..errors import AtomError

__all__ = ["Topology"]


class Topology:
    def __init__(self, n_atoms: int = 0):
        n = int(n_atoms)
        self.n_atoms = n
        self.mass = np.full(n, np.nan, dtype=np.float32)
        self.has_mass = np.zeros(n, dtype=bool)
        self.charge = np.full(n, np.nan, dtype=np.float32)
        self.has_charge = np.zeros(n, dtype=bool)
        self.element_symbol = np.full(n, "", dtype="<U2")
        self.atomname = np.full(n, "", dtype="<U8")
        self._pairs = np.zeros((0, 2), np.int64)  # unique, i <= j
        self._invalidate_bonds()

    # ------------------------------------------------------------ bonds
    def _invalidate_bonds(self) -> None:
        self._csr = None
        self._molecule_id = None

    def set_bonds_from_pairs(self, pairs) -> None:
        """Replace every bond by the (i, j) pairs of `pairs` ([K, 2])."""
        p = np.asarray(pairs, np.int64).reshape(-1, 2)
        if p.size and (p.min() < 0 or p.max() >= self.n_atoms):
            raise AtomError("bond index out of range", code="OutOfRange")
        p = np.sort(p, axis=1)
        self._pairs = (np.unique(p, axis=0) if p.shape[0]
                       else np.zeros((0, 2), np.int64))
        self._invalidate_bonds()

    def add_bond(self, i: int, j: int) -> None:
        """reference: System::add_bond (modifying.rs:235)."""
        n = self.n_atoms
        if i == j:
            raise AtomError(f"atom cannot bond to itself (index {i})",
                            code="SelfBonding")
        if not (0 <= i < n) or not (0 <= j < n):
            raise AtomError(f"bond index out of range: {i}-{j}", code="OutOfRange")
        self.set_bonds_from_pairs(np.concatenate([self._pairs, [[i, j]]]))

    def bonds_csr(self):
        """CSR adjacency (offsets int64[N+1], neighbours int64[nnz]) with
        each atom's neighbours sorted."""
        if self._csr is None:
            i, j = self._pairs[:, 0], self._pairs[:, 1]
            key = np.unique(np.concatenate([i * self.n_atoms + j,
                                            j * self.n_atoms + i]))
            rows, cols = np.divmod(key, max(self.n_atoms, 1))
            offsets = np.zeros(self.n_atoms + 1, np.int64)
            np.cumsum(np.bincount(rows, minlength=self.n_atoms), out=offsets[1:])
            self._csr = (offsets, cols.astype(np.int64))
        return self._csr

    @property
    def bonded(self) -> list:
        """Sorted neighbour list of every atom."""
        offsets, flat = self.bonds_csr()
        return [flat[offsets[a]:offsets[a + 1]].tolist()
                for a in range(self.n_atoms)]

    def molecule_ids(self) -> np.ndarray:
        """Connected-component id per atom over the bond graph, ids
        numbered in the order of each molecule's first atom
        (`groan_rs_tpu/core/topology.py:216-249`)."""
        if self._molecule_id is None:
            from scipy.sparse import coo_matrix
            from scipy.sparse.csgraph import connected_components

            n = self.n_atoms
            i, j = self._pairs[:, 0], self._pairs[:, 1]
            graph = coo_matrix((np.ones(i.shape[0], np.int8), (i, j)),
                               shape=(n, n))
            _, labels = connected_components(graph, directed=False)
            _, first = np.unique(labels, return_index=True)
            rank = np.empty(first.shape[0], np.int64)
            rank[np.argsort(first)] = np.arange(first.shape[0])
            self._molecule_id = rank[labels]
        return self._molecule_id
