"""Per-atom topology columns and the bond graph.

The port of `groan_rs_tpu.core.topology` (`StrColumn` :25-91, `Topology`
:98-144) for what the readers fill, GSL reads and the observables use:

- string columns `resname`, `atomname`, `chain`, `element_name` and
  `element_symbol` as interned `StrColumn`s (unique categories + int32
  codes), so name predicates run once per unique name.  Assigning a
  plain per-atom string array to one of them interns it;
- `resnum`, `atomnum` (int64), `mass` / `has_mass`, `charge` /
  `has_charge`, `vdw` / `has_vdw` (float32 with presence masks) and the
  expected minimum and maximum bond counts;
- bonds: `add_bond`, `set_bonds_from_pairs`, `clear_bonds`, the sorted
  adjacency lists `bonded`, its CSR form `bonds_csr`, `molecule_ids` and
  `mol_references` (JAX `:185`, `:251`);
- `copy` and `subset` (a System's copy and extraction).

Bonds are held as one deduplicated `[K, 2]` pair array; the CSR and the
molecule ids are built from it with numpy and scipy's connected
components (no per-atom Python loop: at 1M atoms the JAX package's BFS
costs seconds of host time).  Molecule ids are ordered by each
molecule's first atom, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..errors import AtomError

__all__ = ["StrColumn", "Topology"]


class StrColumn:
    """Interned string column: `categories` list + int32 `codes`."""

    __slots__ = ("categories", "codes", "_lookup")

    def __init__(self, values=None, categories=None, codes=None):
        if values is not None:
            values = np.asarray(values)
            if values.dtype.kind not in ("S", "U"):
                values = values.astype(object)
            # unique on the native S/U dtype: byte-level comparison is
            # several times faster than object-array sorting at 1M atoms
            cats, codes = np.unique(values, return_inverse=True)
            self.categories = [
                c.decode() if isinstance(c, bytes) else str(c) for c in cats
            ]
            self.codes = codes.reshape(-1).astype(np.int32)
        else:
            self.categories = list(categories or [])
            self.codes = (
                np.empty(0, dtype=np.int32) if codes is None else np.asarray(codes, dtype=np.int32)
            )
        self._lookup = {c: i for i, c in enumerate(self.categories)}

    @classmethod
    def filled(cls, n: int, value: str = "") -> "StrColumn":
        return cls(categories=[value], codes=np.zeros(int(n), np.int32))

    def __len__(self):
        return self.codes.shape[0]

    def __getitem__(self, i) -> str:
        return self.categories[self.codes[i]]

    def get(self, i) -> str:
        return self.categories[self.codes[i]]

    def _code(self, value: str) -> int:
        code = self._lookup.get(value)
        if code is None:
            code = len(self.categories)
            self.categories.append(value)
            self._lookup[value] = code
        return code

    def set(self, i, value: str):
        self.codes[i] = self._code(value)

    def set_where(self, mask, value: str):
        """`value` at every atom of the boolean `mask` (or index array)."""
        self.codes[mask] = self._code(value)

    def copy(self) -> "StrColumn":
        return StrColumn(categories=list(self.categories), codes=self.codes.copy())

    def take(self, idx) -> "StrColumn":
        """The column of the atoms `idx` (categories kept)."""
        return StrColumn(categories=list(self.categories), codes=self.codes[idx].copy())

    def values(self) -> np.ndarray:
        cats = np.asarray(self.categories, dtype=object)
        if not len(cats):
            return np.empty(0, dtype=object)
        return cats[self.codes]

    # ------------------------------------------------------------ vectorized matching
    def mask_equal(self, name: str) -> np.ndarray:
        code = self._lookup.get(name)
        if code is None:
            return np.zeros(len(self), dtype=bool)
        return self.codes == code

    def mask_predicate(self, pred) -> np.ndarray:
        """Evaluate `pred(category) -> bool` per unique category, gather."""
        table = np.fromiter((bool(pred(c)) for c in self.categories), dtype=bool,
                            count=len(self.categories))
        if table.size == 0:
            return np.zeros(len(self), dtype=bool)
        return table[self.codes]


def _opt_float(n):
    return np.full(n, np.nan, dtype=np.float32), np.zeros(n, dtype=bool)


def _str_column(name: str):
    """A `StrColumn` attribute that interns a plain per-atom array
    assigned to it."""
    key = "_" + name

    def get(self) -> StrColumn:
        return getattr(self, key)

    def set_(self, value) -> None:
        if not isinstance(value, StrColumn):
            value = StrColumn(values=np.asarray(value).reshape(-1))
        if len(value) != self.n_atoms:
            raise AtomError(f"{name} has {len(value)} entries for "
                            f"{self.n_atoms} atoms", code="InvalidColumn")
        setattr(self, key, value)

    return property(get, set_)


class Topology:
    """Columnar static atom metadata + bond graph."""

    resname = _str_column("resname")
    atomname = _str_column("atomname")
    chain = _str_column("chain")  # '' = no chain
    element_name = _str_column("element_name")  # '' = no element
    element_symbol = _str_column("element_symbol")

    def __init__(self, n_atoms: int = 0):
        n = int(n_atoms)
        self.n_atoms = n
        self.resnum = np.zeros(n, dtype=np.int64)
        self.atomnum = np.zeros(n, dtype=np.int64)
        for name in ("resname", "atomname", "chain", "element_name",
                     "element_symbol"):
            setattr(self, name, StrColumn.filled(n))
        self.charge, self.has_charge = _opt_float(n)
        self.mass, self.has_mass = _opt_float(n)
        self.vdw, self.has_vdw = _opt_float(n)
        self.expected_min_bonds = np.zeros(n, dtype=np.int32)
        self.has_expected_min_bonds = np.zeros(n, dtype=bool)
        self.expected_max_bonds = np.zeros(n, dtype=np.int32)
        self.has_expected_max_bonds = np.zeros(n, dtype=bool)
        self._pairs = np.zeros((0, 2), np.int64)  # unique, i <= j
        self._invalidate_bonds()

    # ------------------------------------------------------------ construction
    @classmethod
    def from_columns(cls, resnum, resname, atomname, atomnum, **optional) -> "Topology":
        """(JAX `core/topology.py:126-144`.)"""
        resnum = np.asarray(resnum, dtype=np.int64)
        topo = cls(resnum.shape[0])
        topo.resnum = resnum
        topo.resname = StrColumn(values=resname)
        topo.atomname = StrColumn(values=atomname)
        topo.atomnum = np.asarray(atomnum, dtype=np.int64)
        if optional.get("chain") is not None:
            topo.chain = StrColumn(values=optional["chain"])
        for field in ("charge", "mass", "vdw"):
            if optional.get(field) is not None:
                vals = np.asarray(optional[field], dtype=np.float32)
                setattr(topo, field, vals)
                present = optional.get("has_" + field)
                if present is None:
                    present = ~np.isnan(vals)
                setattr(topo, "has_" + field, np.asarray(present, dtype=bool))
        return topo

    # ------------------------------------------------------------ bonds
    def _invalidate_bonds(self) -> None:
        self._csr = None
        self._molecule_id = None

    def has_bonds(self) -> bool:
        return self._pairs.shape[0] > 0

    def bond_pairs(self) -> np.ndarray:
        """The unique bonds as `[K, 2]` (i < j), sorted."""
        return self._pairs

    def set_bonds_from_pairs(self, pairs) -> None:
        """Replace every bond by the (i, j) pairs of `pairs` ([K, 2])."""
        p = np.asarray(pairs, np.int64).reshape(-1, 2)
        if p.size and (p.min() < 0 or p.max() >= self.n_atoms):
            raise AtomError("bond index out of range", code="OutOfRange")
        p = np.sort(p, axis=1)
        self._pairs = (np.unique(p, axis=0) if p.shape[0]
                       else np.zeros((0, 2), np.int64))
        self._invalidate_bonds()

    def clear_bonds(self) -> None:
        """reference: System::clear_bonds (modifying.rs:480)."""
        self.set_bonds_from_pairs(np.zeros((0, 2), np.int64))

    def remove_bonds_of(self, i: int) -> None:
        """Drop every bond of atom `i` (both directions)."""
        keep = (self._pairs != i).all(axis=1)
        self._pairs = self._pairs[keep]
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

    def mol_references(self) -> np.ndarray:
        """First atom of each molecule, in molecule-id order (reference:
        system/mod.rs:65-69)."""
        mol = self.molecule_ids()
        first = np.full(int(mol.max()) + 1 if mol.size else 0, self.n_atoms, np.int64)
        np.minimum.at(first, mol, np.arange(self.n_atoms))
        return first

    def n_molecules(self) -> int:
        mol = self.molecule_ids()
        return int(mol.max()) + 1 if mol.size else 0

    def molecule_indices(self, atom_index: int) -> np.ndarray:
        """All atoms in the molecule of `atom_index`, sorted."""
        mol = self.molecule_ids()
        return np.nonzero(mol == mol[atom_index])[0].astype(np.int64)

    # ------------------------------------------------------------ copies
    def _columns_from(self, src, idx) -> "Topology":
        """Fill this topology's columns with `src`'s rows `idx` (a slice
        or an index array)."""
        self.resnum = src.resnum[idx].copy()
        self.atomnum = src.atomnum[idx].copy()
        for name in ("resname", "atomname", "chain", "element_name",
                     "element_symbol"):
            setattr(self, name, getattr(src, name).take(idx))
        for f in ("charge", "mass", "vdw", "expected_min_bonds",
                  "expected_max_bonds"):
            setattr(self, f, getattr(src, f)[idx].copy())
            setattr(self, "has_" + f, getattr(src, "has_" + f)[idx].copy())
        return self

    def copy(self) -> "Topology":
        t = Topology(self.n_atoms)._columns_from(self, slice(None))
        t._pairs = self._pairs.copy()
        return t

    @classmethod
    def concat(cls, topos) -> "Topology":
        """A new topology of `topos` in order: bond pairs offset, atom
        numbers renumbered 1..N, string columns merged category by
        category (JAX `core/topology.py:288`; system preparation needs
        it)."""
        topos = list(topos)
        t = cls(sum(x.n_atoms for x in topos))
        if not topos:
            return t
        t.atomnum = np.arange(1, t.n_atoms + 1, dtype=np.int64)
        t.resnum = np.concatenate([x.resnum for x in topos])
        for name in ("resname", "atomname", "chain", "element_name",
                     "element_symbol"):
            merged = StrColumn()
            codes = [np.fromiter((merged._code(c) for c in col.categories), np.int32,
                                 len(col.categories))[col.codes]
                     if len(col) else np.zeros(0, np.int32)
                     for col in (getattr(x, name) for x in topos)]
            merged.codes = np.concatenate(codes)
            setattr(t, name, merged)
        for f in ("charge", "mass", "vdw", "expected_min_bonds",
                  "expected_max_bonds"):
            setattr(t, f, np.concatenate([getattr(x, f) for x in topos]))
            setattr(t, "has_" + f, np.concatenate([getattr(x, "has_" + f) for x in topos]))
        offs = np.cumsum([0] + [x.n_atoms for x in topos[:-1]])
        t.set_bonds_from_pairs(np.concatenate(
            [x.bond_pairs() + o for x, o in zip(topos, offs)]))
        return t

    def subset(self, indices) -> "Topology":
        """The topology of the atoms `indices`, the bonds among them
        renumbered (reference analogue: System::group_extract,
        system/mod.rs:479)."""
        idx = np.asarray(indices, np.int64)
        t = Topology(idx.shape[0])._columns_from(self, idx)
        new = np.full(self.n_atoms, -1, np.int64)
        new[idx] = np.arange(idx.shape[0])
        p = new[self._pairs]
        t.set_bonds_from_pairs(p[(p >= 0).all(axis=1)])
        return t
