"""The error classes the ported slice raises.

Same names, hierarchy roots and `code=` strings as `groan_rs_tpu.errors`
(itself mirroring the reference's `src/errors.rs`), so callers match on
failure kinds identically in both packages.
"""

from __future__ import annotations


class GroanError(Exception):
    """Base class of every groan_rs_tpu_torch error."""

    def __init__(self, message: str = "", *, code: str = ""):
        self.code = code or type(self).__name__
        super().__init__(message)


class TrajError(GroanError):
    """Base of trajectory I/O errors."""


class ReadTrajError(TrajError):
    """reference: errors.rs ReadTrajError."""


class WriteTrajError(TrajError):
    """reference: errors.rs WriteTrajError."""


class GroupError(GroanError):
    """reference: errors.rs GroupError (nonexistent group, invalid name...)."""


class AtomError(GroanError):
    """reference: errors.rs AtomError (bond to itself, index out of range)."""


class SimBoxError(GroanError):
    """reference: errors.rs SimBoxError (missing / non-orthogonal box)."""


class ShapeError(GroanError):
    """reference: errors.rs ShapeError (a shape that cannot be built or
    has no batched membership test)."""


class RMSDError(GroanError):
    """reference: errors.rs RMSDError."""


class ParallelError(GroanError):
    """Errors surfaced from the parallel pass engine."""
