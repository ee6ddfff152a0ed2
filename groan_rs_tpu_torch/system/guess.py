"""Element and property guessing (reference: `src/system/guess.rs`).

Port of `groan_rs_tpu/system/guess.py` (`guess_elements`,
`guess_elements_unknown`, `guess_properties` :28-156).  Each element's
GSL query compiles to one `bool[N]` mask, as in the JAX package; the
assignment then runs per element over a mask (the JAX package sets one
atom at a time through `StrColumn.set`, which costs seconds at 1M
atoms).  The columns set and the warnings are the JAX package's: the
first matching element wins, atoms matching none or several surface as
one `GuessWarning`, and the system is modified all the same.

`guess_bonds` (JAX `:159-255`): bond i-j when their minimum-image
distance is below `radius_factor * (vdw_i + vdw_j)` (0.55 by default),
candidates gathered over the 27 neighbour cells of a `CellGrid` with one
CSR gather per relative offset, as in the JAX package.  The over- and
under-bonded counts come from the bond CSR, not from per-atom lists.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..core.elements import Elements
from ..errors import ElementError, GuessWarning, SelectError

__all__ = ["GuessMixin", "DEFAULT_RADIUS_FACTOR"]

DEFAULT_RADIUS_FACTOR = 0.55  # reference: guess.rs:19


def _set_properties(topo, where, elem, symbol: bool = True) -> None:
    """Mass, vdw and expected bond counts of `elem` on the atoms `where`
    (reference: set_atom_properties, guess.rs:520); the element symbol
    too with `symbol`."""
    if symbol and elem.symbol is not None:
        topo.element_symbol.set_where(where, elem.symbol)
    for field in ("mass", "vdw", "expected_max_bonds", "expected_min_bonds"):
        v = getattr(elem, field)
        if v is not None:
            getattr(topo, field)[where] = v
            getattr(topo, "has_" + field)[where] = True


class GuessMixin:
    def guess_elements(self, elements: Elements | None = None):
        """Assign elements to all atoms (reference: guess.rs:114)."""
        self._guess_elements_partial(elements or Elements.default(), for_all=True)

    def guess_elements_unknown(self, elements: Elements | None = None):
        """Assign elements only to atoms without one (reference: guess.rs:125)."""
        self._guess_elements_partial(elements or Elements.default(), for_all=False)

    def _element_masks(self, elements: Elements) -> list[tuple[str, np.ndarray]]:
        from ..select.compile import evaluate_mask

        masks = []
        for name, elem in elements.elements.items():
            if elem.select is None:
                continue
            try:
                masks.append((name, evaluate_mask(elem.select, self)))
            except SelectError as e:
                raise ElementError(
                    f"invalid query of element '{name}': {e}", code="InvalidQuery"
                ) from e
        return masks

    def _guess_elements_partial(self, elements: Elements, for_all: bool):
        topo = self.topology
        n = self.get_n_atoms()
        masks = self._element_masks(elements)

        eligible = np.ones(n, dtype=bool)
        if not for_all:
            eligible = ~(topo.element_name.mask_predicate(bool)
                         | topo.element_symbol.mask_predicate(bool))

        count = np.zeros(n, np.int32)
        first = np.full(n, -1, np.int64)
        for e, (_, m) in enumerate(masks):
            count += m
            first[(first < 0) & m] = e
        names = [name for name, _ in masks]
        for e, name in enumerate(names):
            where = eligible & (first == e)
            if where.any():
                topo.element_name.set_where(where, name)
                _set_properties(topo, where, elements.elements[name])

        n_none = int((eligible & (count == 0)).sum())
        multi = np.flatnonzero(eligible & (count > 1))
        keys = set()
        if multi.shape[0]:
            rows = np.unique(np.stack([m[multi] for _, m in masks], axis=1), axis=0)
            keys = {tuple(names[e] for e in np.flatnonzero(r)) for r in rows}
        if n_none or multi.shape[0]:
            warnings.warn(
                GuessWarning(
                    f"element guessing: {n_none} atom(s) matched no element; "
                    f"{multi.shape[0]} atom(s) matched multiple "
                    f"elements {sorted(keys)}"
                ),
                stacklevel=3,
            )

    def guess_properties(self, elements: Elements | None = None):
        """Assign mass/vdw/bond expectations from already-assigned element
        names (reference: guess.rs:255)."""
        elements = elements or Elements.default()
        topo = self.topology
        info = dict.fromkeys(("no_element", "not_recognized", "no_mass", "no_vdw",
                              "no_max_bonds", "no_min_bonds"), 0)
        col = topo.element_name
        for code, elname in enumerate(list(col.categories)):
            where = col.codes == code
            k = int(where.sum())
            if not k:
                continue
            elem = elements.get(elname) if elname else None
            if not elname:
                info["no_element"] += k
            elif elem is None:
                info["not_recognized"] += k
            else:
                _set_properties(topo, where, elem, symbol=False)
                for field, key in (("mass", "no_mass"), ("vdw", "no_vdw"),
                                   ("expected_max_bonds", "no_max_bonds"),
                                   ("expected_min_bonds", "no_min_bonds")):
                    if getattr(elem, field) is None:
                        info[key] += k
        if any(info.values()):
            warnings.warn(
                GuessWarning("property guessing incomplete: " +
                             ", ".join(f"{k}={v}" for k, v in info.items() if v)),
                stacklevel=2,
            )

    # ------------------------------------------------------------- bonds
    def guess_bonds(self, radius_factor: float | None = None):
        """Guess bonds from vdw radii (reference: guess.rs:362): bond if
        distance < radius_factor * (vdw_i + vdw_j).  Replaces every bond."""
        import torch

        from ..core.cellgrid import CellGrid, axis_offsets, wrap_f32
        from ..errors import CellGridError
        from ..ops import pbc

        n = self.get_n_atoms()
        if n == 0:
            return
        factor = radius_factor if radius_factor is not None else DEFAULT_RADIUS_FACTOR
        topo = self.topology
        has_vdw = topo.has_vdw
        n_no_vdw = int((~has_vdw).sum())
        max_vdw = float(topo.vdw[has_vdw].max()) if has_vdw.any() else 0.0
        cell = 2.0 * factor * max_vdw
        if cell <= 0.0:
            raise ElementError("no van der Waals radii available", code="BondGuessError")
        try:
            grid = CellGrid(self, "all", cell)
        except CellGridError as e:
            raise ElementError(str(e), code="BondGuessError") from e

        box = self.box_lengths().astype(np.float32)
        pos = self.positions.astype(np.float32, copy=False)
        ncells, cell_off = grid.ncells, grid.offsets
        coords = grid._coords(wrap_f32(pos, box))

        # one CSR gather per relative offset over the 27-neighbourhood
        pair_i, pair_j = [], []
        for dx in axis_offsets(int(ncells[0])):
            for dy in axis_offsets(int(ncells[1])):
                for dz in axis_offsets(int(ncells[2])):
                    nb0 = (coords[:, 0] + dx) % ncells[0]
                    nb1 = (coords[:, 1] + dy) % ncells[1]
                    nb2 = (coords[:, 2] + dz) % ncells[2]
                    cid = (nb0 * ncells[1] + nb1) * ncells[2] + nb2
                    s = cell_off[cid]
                    cnt = cell_off[cid + 1] - s
                    nz = np.nonzero(cnt)[0]
                    if nz.shape[0] == 0:
                        continue
                    c = cnt[nz]
                    rep_i = np.repeat(nz, c)
                    within = np.arange(rep_i.shape[0]) - np.repeat(np.cumsum(c) - c, c)
                    rep_j = grid.sorted_atoms[np.repeat(s[nz], c) + within]
                    keep = rep_i < rep_j  # each unordered pair once, no self
                    pair_i.append(rep_i[keep])
                    pair_j.append(rep_j[keep])

        pairs = np.zeros((0, 2), np.int64)
        if pair_i:
            pi, pj = np.concatenate(pair_i), np.concatenate(pair_j)
            ok = has_vdw[pi] & has_vdw[pj]
            pi, pj = pi[ok], pj[ok]
            d = pbc.min_image(torch.from_numpy(pos[pi] - pos[pj]),
                              torch.from_numpy(box)).numpy()
            dist = np.sqrt(np.einsum("ij,ij->i", d, d))
            limit = (factor * (topo.vdw[pi] + topo.vdw[pj])).astype(np.float32)
            hit = dist < limit
            pairs = np.stack([pi[hit], pj[hit]], 1)
        topo.set_bonds_from_pairs(pairs)

        # over/under-bonded warnings (reference: check_unexpected_bonds)
        offsets, _ = topo.bonds_csr()
        n_bonded = np.diff(offsets)
        too_many = int((topo.has_expected_max_bonds
                        & (n_bonded > topo.expected_max_bonds)).sum())
        too_few = int((topo.has_expected_min_bonds
                       & (n_bonded < topo.expected_min_bonds)).sum())
        if n_no_vdw or too_many or too_few:
            warnings.warn(
                GuessWarning(
                    f"bond guessing: {n_no_vdw} atom(s) without vdw, "
                    f"{too_many} over-bonded, {too_few} under-bonded"
                ),
                stacklevel=2,
            )
