"""AtomContainer: run-length encoded sorted index sets.

Port of `groan_rs_tpu.core.container` (the reference's `AtomContainer`,
`src/structures/container.rs:13-31`): groups are stored as sorted
inclusive `[start, end]` blocks.  Same semantics as the JAX package:
`from_indices` drops indices out of range and `from_ranges` clips and
merges (`:47-79`).  Block expansion and masks are vectorised here (the
JAX package loops over blocks in Python, which costs ~0.3 s for a
scattered 1M-atom selection).
"""

from __future__ import annotations

import numpy as np

__all__ = ["AtomContainer"]


def _blocks_from_sorted_unique(idx: np.ndarray) -> np.ndarray:
    """Compress a sorted unique int array into inclusive [start, end] blocks."""
    if idx.size == 0:
        return np.empty((0, 2), dtype=np.int64)
    breaks = np.nonzero(np.diff(idx) > 1)[0]
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [idx.size - 1]))
    return np.stack([idx[starts], idx[ends]], axis=1)


def _merge(blocks: np.ndarray) -> np.ndarray:
    """Merge overlapping or adjacent inclusive blocks, sorted by start."""
    if blocks.shape[0] == 0:
        return np.empty((0, 2), dtype=np.int64)
    b = blocks[np.argsort(blocks[:, 0], kind="stable")]
    ends = np.maximum.accumulate(b[:, 1])
    new = np.ones(b.shape[0], bool)
    new[1:] = b[1:, 0] > ends[:-1] + 1
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, b.shape[0] - 1)
    return np.stack([b[first, 0], ends[last]], axis=1).astype(np.int64)


class AtomContainer:
    """Sorted set of atom indices stored as inclusive blocks."""

    __slots__ = ("blocks", "_indices_cache")

    def __init__(self, blocks: np.ndarray | None = None):
        self.blocks = (
            np.empty((0, 2), dtype=np.int64)
            if blocks is None
            else np.asarray(blocks, dtype=np.int64).reshape(-1, 2)
        )
        self._indices_cache = None

    # ------------------------------------------------------------ constructors
    @classmethod
    def empty(cls) -> "AtomContainer":
        return cls()

    @classmethod
    def from_indices(cls, indices, n_atoms: int | None = None) -> "AtomContainer":
        """From an arbitrary iterable of indices; deduplicates and sorts.
        Indices outside [0, n_atoms) are dropped (reference behaviour,
        container.rs)."""
        idx = np.unique(np.asarray(
            indices if isinstance(indices, np.ndarray) else list(indices),
            dtype=np.int64))
        if n_atoms is not None:
            idx = idx[(idx >= 0) & (idx < n_atoms)]
        return cls(_blocks_from_sorted_unique(idx))

    @classmethod
    def from_ranges(cls, ranges, n_atoms: int | None = None) -> "AtomContainer":
        """From inclusive (start, end) ranges; overlapping ranges are merged
        and, with `n_atoms`, clipped to the system."""
        norm = []
        for start, end in ranges:
            if n_atoms is not None:
                end = min(end, n_atoms - 1)
            if end < start or end < 0:
                continue
            norm.append((max(0, int(start)), int(end)))
        return cls(_merge(np.asarray(norm, np.int64).reshape(-1, 2)))

    @classmethod
    def from_mask(cls, mask: np.ndarray) -> "AtomContainer":
        idx = np.nonzero(np.asarray(mask))[0].astype(np.int64)
        return cls(_blocks_from_sorted_unique(idx))

    # ------------------------------------------------------------ conversions
    def indices(self) -> np.ndarray:
        """Expanded sorted index array (cached)."""
        if self._indices_cache is None:
            s, e = self.blocks[:, 0], self.blocks[:, 1]
            lens = e - s + 1
            total = int(lens.sum())
            starts = np.repeat(s - np.cumsum(lens) + lens, lens)
            self._indices_cache = (starts + np.arange(total)).astype(np.int64)
        return self._indices_cache

    def mask(self, n_atoms: int) -> np.ndarray:
        out = np.zeros(n_atoms, dtype=bool)
        out[self.indices()] = True
        return out

    # ------------------------------------------------------------ queries
    def get_n_atoms(self) -> int:
        if self.blocks.shape[0] == 0:
            return 0
        return int(np.sum(self.blocks[:, 1] - self.blocks[:, 0] + 1))

    def __len__(self) -> int:
        return self.get_n_atoms()

    def is_empty(self) -> bool:
        return self.blocks.shape[0] == 0

    def isin(self, index: int) -> bool:
        """Binary search over the blocks (reference: container.rs:254)."""
        pos = int(np.searchsorted(self.blocks[:, 0], index, side="right")) - 1
        return pos >= 0 and index <= self.blocks[pos, 1]

    def first(self) -> int | None:
        return int(self.blocks[0, 0]) if self.blocks.shape[0] else None

    def last(self) -> int | None:
        return int(self.blocks[-1, 1]) if self.blocks.shape[0] else None

    def __iter__(self):
        for s, e in self.blocks:
            yield from range(int(s), int(e) + 1)

    def iter(self):
        """reference: container.rs iter (Python iteration)."""
        return self.__iter__()

    def __eq__(self, other) -> bool:
        return isinstance(other, AtomContainer) and np.array_equal(self.blocks, other.blocks)

    def __repr__(self) -> str:  # pragma: no cover
        return f"AtomContainer({self.get_n_atoms()} atoms, {self.blocks.shape[0]} blocks)"

    # ------------------------------------------------------------ set algebra
    def union(self, other: "AtomContainer") -> "AtomContainer":
        """reference: container.rs:272"""
        return AtomContainer(_merge(np.concatenate([self.blocks, other.blocks])))

    def intersection(self, other: "AtomContainer") -> "AtomContainer":
        """reference: container.rs:283"""
        mine = self.indices()
        return AtomContainer(_blocks_from_sorted_unique(
            mine[np.isin(mine, other.indices(), assume_unique=True)]))

    def difference(self, other: "AtomContainer") -> "AtomContainer":
        """The atoms of this container that `other` does not hold."""
        if self.is_empty() or other.is_empty():
            return AtomContainer(self.blocks.copy())
        mine = self.indices()
        return AtomContainer(_blocks_from_sorted_unique(
            mine[~np.isin(mine, other.indices(), assume_unique=True)]))

    def add(self, index: int) -> "AtomContainer":
        """A new container with `index` inserted."""
        return self.union(AtomContainer(np.array([[index, index]], np.int64)))
