"""Visual centring and labeled atoms (reference: `src/system/utility.rs`,
`src/system/labeled_atoms.rs`).

Port of `groan_rs_tpu/system/utility.py:36-112`; the NDX methods of that
module sit on `System` itself (`system/core.py`).  The centring methods
estimate the reference group's centre (K1 on the card) and translate
every atom on the System's device.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..core.dimension import Dimension
from ..errors import GroupError, LabelError, SelectError
from .groups import name_is_valid

__all__ = ["UtilityMixin"]


class UtilityMixin:
    # ------------------------------------------------------------- centring
    def _center_on(self, reference: str, dimension: Dimension, estimate):
        if self.group_get_n_atoms(reference) == 0:  # raises NotFound first
            raise GroupError(f"group '{reference}' is empty", code="EmptyGroup")
        ref_center = estimate(reference)  # before the box: its errors come first
        self.atoms_translate((self.get_box_center() - ref_center) * dimension.mask())

    def atoms_center(self, reference: str, dimension: Dimension):
        """Move the reference group's estimated centre of geometry to the
        box centre along `dimension` (reference: utility.rs:109)."""
        self._center_on(reference, dimension, self.group_estimate_center)

    def atoms_center_mass(self, reference: str, dimension: Dimension):
        """The same with the estimated centre of mass (reference:
        utility.rs:168)."""
        self._center_on(reference, dimension, self.group_estimate_com)

    # ------------------------------------------------------------- labels
    def label_atom(self, label: str, index: int):
        """reference: labeled_atoms.rs:41."""
        if not name_is_valid(label):
            raise LabelError(f"invalid label name '{label}'", code="InvalidName")
        if not (0 <= index < self.get_n_atoms()):
            raise LabelError(f"atom index {index} out of range", code="IndexOutOfRange")
        if label in self.labeled_atoms:
            warnings.warn(f"label '{label}' already existed and was overwritten",
                          UserWarning, stacklevel=2)
        self.labeled_atoms[label] = int(index)

    def select_and_label(self, label: str, query: str):
        """Label the single atom matching `query` (reference: labeled_atoms.rs:81)."""
        from ..select import evaluate_mask, parse_query

        try:
            mask = evaluate_mask(parse_query(query), self)
        except SelectError as e:
            raise LabelError(f"invalid query '{query}': {e}", code="InvalidQuery") from e
        idx = np.nonzero(mask)[0]
        if idx.shape[0] != 1:
            raise LabelError(f"query '{query}' selected {idx.shape[0]} atoms (expected 1)",
                             code="InvalidNumberOfAtoms")
        self.label_atom(label, int(idx[0]))

    def label_exists(self, label: str) -> bool:
        return label in self.labeled_atoms

    def get_labeled_atom(self, label: str):
        """reference: labeled_atoms.rs:151."""
        if label not in self.labeled_atoms:
            raise LabelError(f"label '{label}' does not exist", code="NotFound")
        return self.get_atom(self.labeled_atoms[label])

    get_labeled_atom_mut = get_labeled_atom
    get_labeled_atom_copy = get_labeled_atom

    def labeled_atoms_iter(self):
        """reference: labeled_atoms.rs:219."""
        for label, idx in self.labeled_atoms.items():
            yield label, self.get_atom(idx)

    labeled_atoms_iter_mut = labeled_atoms_iter

    def unlabel_atom(self, label: str):
        if label not in self.labeled_atoms:
            raise LabelError(f"label '{label}' does not exist", code="NotFound")
        del self.labeled_atoms[label]
