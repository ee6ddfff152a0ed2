"""Named groups and the methods that create and combine them.

Port of `groan_rs_tpu/system/core.py` (`name_is_valid` :33, `Group`
:43-132, `_add_group` :281-290) and `system/groups.py` (`group_create`
:16 ... `group_names_writable` :165).  Group-by-geometry evaluates the
shapes' `inside` on the System's device.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..core.container import AtomContainer
from ..errors import GroupError, SelectError

__all__ = ["FORBIDDEN_NAME_CHARS", "name_is_valid", "Group",
           "GroupOverwriteWarning", "GroupsMixin"]

#: characters forbidden in group/label names (reference: auxiliary.rs:37)
FORBIDDEN_NAME_CHARS = "'\"&|!@()<>="


def name_is_valid(name: str) -> bool:
    if not name or not name.strip():
        return False
    return not any(c in FORBIDDEN_NAME_CHARS for c in name)


class GroupOverwriteWarning(UserWarning):
    """reference: GroupError::AlreadyExistsWarning (non-fatal overwrite)."""


class Group:
    """A named selection (reference: `src/structures/group.rs:23`);
    `print_ndx` says whether `write_ndx` writes it."""

    __slots__ = ("atoms", "print_ndx")

    def __init__(self, atoms: AtomContainer, print_ndx: bool = True):
        self.atoms = atoms
        self.print_ndx = print_ndx

    def get_n_atoms(self) -> int:
        return self.atoms.get_n_atoms()

    def copy(self) -> "Group":
        return Group(AtomContainer(self.atoms.blocks.copy()), self.print_ndx)


def _query_mask(system, query: str) -> np.ndarray:
    from ..select import evaluate_mask, parse_query

    try:
        return evaluate_mask(parse_query(query), system)
    except SelectError as e:
        raise GroupError(f"invalid query '{query}': {e}", code="InvalidQuery") from e


def _check_name(name: str) -> None:
    if not name_is_valid(name):
        raise GroupError(f"invalid group name '{name}'", code="InvalidName")


class GroupsMixin:
    """Group methods of `System` (reference: `src/system/groups.rs`)."""

    # ------------------------------------------------------------- registry
    def _get_group(self, name: str) -> Group:
        try:
            return self.groups[name]
        except KeyError:
            raise GroupError(f"group '{name}' does not exist", code="NotFound") from None

    def _add_group(self, name: str, group: Group) -> None:
        _check_name(name)
        if name in self.groups:
            warnings.warn(f"group '{name}' already existed and was overwritten",
                          GroupOverwriteWarning, stacklevel=3)
        self.groups[name] = group

    def group_exists(self, name: str) -> bool:
        return name in self.groups

    def group_names(self) -> list[str]:
        return list(self.groups)

    def group_indices(self, name: str) -> np.ndarray:
        """Sorted atom indices of a group."""
        return self._get_group(name).atoms.indices()

    # ------------------------------------------------------------- creation
    def group_create(self, name: str, query: str) -> None:
        """Create a group from a GSL query (reference: groups.rs:43)."""
        _check_name(name)
        self._add_group(name, Group(AtomContainer.from_mask(_query_mask(self, query))))

    def group_create_from_select(self, name: str, select) -> None:
        """reference: groups.rs:295 (pre-parsed Select tree)."""
        from ..select import evaluate_mask

        _check_name(name)
        self._add_group(name, Group(AtomContainer.from_mask(evaluate_mask(select, self))))

    def group_create_from_geometry(self, name: str, query: str, geometry) -> None:
        """reference: groups.rs:94 — query AND inside(shape)."""
        self.group_create_from_geometries(name, query, [geometry])

    def group_create_from_geometries(self, name: str, query: str, geometries) -> None:
        """reference: groups.rs:164; atoms without a position are never
        selected."""
        from ..ops import interactive

        _check_name(name)
        if not self.has_box():
            raise GroupError("system has no simulation box", code="InvalidSimBox")
        if not self.simbox.is_orthogonal():
            raise GroupError("simulation box is not orthogonal", code="InvalidSimBox")
        mask = _query_mask(self, query) & self.has_position
        dev = self.device
        pts = interactive.put(self.positions, dev)
        box = interactive.put(self.simbox.to_lengths_vec(), dev)
        for geom in geometries:
            mask &= interactive.fetch(geom.inside(pts, box))
        self._add_group(name, Group(AtomContainer.from_mask(mask)))

    def group_create_from_indices(self, name: str, indices) -> None:
        """reference: groups.rs:215 — invalid indices are dropped silently."""
        _check_name(name)
        self._add_group(name, Group(AtomContainer.from_indices(indices, self.get_n_atoms())))

    def group_create_from_ranges(self, name: str, ranges) -> None:
        """reference: groups.rs:249 — inclusive index ranges, clipped to
        the system."""
        _check_name(name)
        self._add_group(name, Group(AtomContainer.from_ranges(ranges, self.get_n_atoms())))

    # ------------------------------------------------------------- splitting
    def _split_by(self, name: str, keys: np.ndarray, label: str) -> list:
        """One group `'<label> <key>'` per distinct key of the group's
        atoms, in order of first appearance -> the new names."""
        idx = self.group_indices(name)
        uniq, first, inv = np.unique(keys[idx], return_index=True,
                                     return_inverse=True)
        inv = inv.reshape(-1)
        order = np.argsort(inv, kind="stable")
        bounds = np.searchsorted(inv[order], np.arange(uniq.shape[0] + 1))
        names = []
        for u in np.argsort(first, kind="stable"):
            gname = f"{label} {uniq[u]}"
            names.append(gname)
            self.group_create_from_indices(gname, idx[order[bounds[u]:bounds[u + 1]]])
        return names

    def atoms_split_by_resid(self) -> list:
        """reference: groups.rs:344 — groups named 'resid X'."""
        return self.group_split_by_resid("all")

    def group_split_by_resid(self, name: str) -> list:
        """reference: groups.rs:391."""
        return self._split_by(name, np.asarray(self.topology.resnum), "resid")

    def atoms_split_by_resname(self) -> list:
        """reference: groups.rs:468 — groups named 'resname X'."""
        return self.group_split_by_resname("all")

    def group_split_by_resname(self, name: str) -> list:
        """reference: groups.rs:514."""
        return self._split_by(name, self.topology.resname.values(), "resname")

    # ------------------------------------------------------------- algebra
    def group_union(self, group1: str, group2: str, union: str) -> None:
        """reference: groups.rs:679."""
        g1, g2 = self._get_group(group1), self._get_group(group2)
        _check_name(union)
        self._add_group(union, Group(g1.atoms.union(g2.atoms)))

    def group_intersection(self, group1: str, group2: str, intersection: str) -> None:
        """reference: groups.rs:699."""
        g1, g2 = self._get_group(group1), self._get_group(group2)
        _check_name(intersection)
        self._add_group(intersection, Group(g1.atoms.intersection(g2.atoms)))

    def group_extend(self, group: str, extend: str) -> None:
        """reference: groups.rs:716 — add the atoms of `extend` to `group`."""
        g, e = self._get_group(group), self._get_group(extend)
        g.atoms = g.atoms.union(e.atoms)

    def groups_member(self, index: int) -> list[str]:
        """Every group holding the atom (reference: groups.rs:781)."""
        return [n for n, g in self.groups.items() if g.atoms.isin(index)]

    def group_remove(self, name: str) -> None:
        """Remove a group; 'all'/'All' cannot be removed."""
        if name in ("all", "All"):
            raise GroupError(f"cannot remove default group '{name}'", code="ProtectedGroup")
        self._get_group(name)
        del self.groups[name]

    def group_rename(self, old: str, new: str) -> None:
        if old in ("all", "All"):
            raise GroupError(f"cannot rename default group '{old}'", code="ProtectedGroup")
        _check_name(new)
        g = self._get_group(old)
        del self.groups[old]
        self._add_group(new, g)

    def group_make_writable(self, name: str) -> None:
        """Write the group in `write_ndx` (reference: groups.rs:565)."""
        self._get_group(name).print_ndx = True

    def group_make_nonwritable(self, name: str) -> None:
        """Leave the group out of `write_ndx` (reference: groups.rs:574)."""
        self._get_group(name).print_ndx = False

    def group_names_writable(self) -> list:
        """Names of ndx-writable groups (reference: groups.rs:743)."""
        return [n for n, g in self.groups.items() if g.print_ndx]
