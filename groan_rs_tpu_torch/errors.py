"""The error classes the port raises.

Same names, hierarchy and `code=` strings as `groan_rs_tpu.errors`
(itself mirroring the reference's `src/errors.rs`), so callers match on
failure kinds identically in both packages.
"""

from __future__ import annotations


class GroanError(Exception):
    """Base class of every groan_rs_tpu_torch error."""

    def __init__(self, message: str = "", *, code: str = ""):
        self.code = code or type(self).__name__
        super().__init__(message)


# ---------------------------------------------------------------- structure parsing
class ParseFileError(GroanError):
    """reference: errors.rs ParseFileError (dispatch level)."""


class ParseGroError(ParseFileError):
    """reference: errors.rs ParseGroError."""


class ParsePdbError(ParseFileError):
    """reference: errors.rs ParsePdbError."""


class ParsePqrError(ParseFileError):
    """reference: errors.rs ParsePqrError."""


class ParseTprError(ParseFileError):
    """reference: errors.rs ParseTprError."""


class ParseNdxError(ParseFileError):
    """reference: errors.rs ParseNdxError."""


class ParseYamlError(ParseFileError):
    """reference: errors.rs ParseElementError yaml arms."""


# ---------------------------------------------------------------- structure writing
class WriteError(GroanError):
    """Base of writer errors."""


class WriteGroError(WriteError):
    """reference: errors.rs WriteGroError."""


class WritePdbError(WriteError):
    """reference: errors.rs WritePdbError."""


class WritePqrError(WriteError):
    """reference: errors.rs WritePqrError."""


class WriteNdxError(WriteError):
    """reference: errors.rs WriteNdxError."""


# ---------------------------------------------------------------- trajectories
class TrajError(GroanError):
    """Base of trajectory I/O errors."""


class ReadTrajError(TrajError):
    """reference: errors.rs ReadTrajError."""


class WriteTrajError(TrajError):
    """reference: errors.rs WriteTrajError."""


class TrajCatError(ReadTrajError):
    """reference: errors.rs arms specific to concatenation."""


class GroupError(GroanError):
    """reference: errors.rs GroupError (nonexistent group, invalid name...)."""


class AtomError(GroanError):
    """reference: errors.rs AtomError (bond to itself, index out of range)."""


class PositionError(AtomError):
    """reference: errors.rs PositionError (atom has no position)."""


class MassError(AtomError):
    """reference: errors.rs MassError (atom has no mass)."""


class SimBoxError(GroanError):
    """reference: errors.rs SimBoxError (missing / non-orthogonal box)."""


class DimensionError(GroanError):
    """Invalid dimension specification."""


class LabelError(GroanError):
    """reference: errors.rs (labeled atoms)."""


class ShapeError(GroanError):
    """reference: errors.rs ShapeError (a shape that cannot be built or
    has no batched membership test)."""


# ---------------------------------------------------------------- selection language
class SelectError(GroanError):
    """reference: errors.rs SelectError."""

    # canonical variant codes used by tests:
    EMPTY_QUERY = "EmptyQuery"
    INVALID_PARENTHESES = "InvalidParentheses"
    INVALID_QUOTES = "InvalidQuotes"
    INVALID_OPERATOR = "InvalidOperator"
    MISSING_ARGUMENT = "MissingArgument"
    EMPTY_ARGUMENT = "EmptyArgument"
    INVALID_NUMBER = "InvalidNumber"
    INVALID_CHAIN_ID = "InvalidChainId"
    INVALID_REGEX = "InvalidRegex"
    INVALID_TOKEN_PARENTHESES = "InvalidTokenParentheses"
    DEPRECATED_KEYWORD = "DeprecatedKeyword"
    GROUP_NOT_FOUND = "GroupNotFound"
    LABEL_NOT_FOUND = "LabelNotFound"
    UNKNOWN = "UnknownError"


# ---------------------------------------------------------------- elements / guessing
class ElementError(GroanError):
    """reference: errors.rs ElementError."""


class GuessError(GroanError):
    """reference: errors.rs (element/bond guessing failures)."""


class GuessWarning(Warning):
    """Non-fatal guessing issues (atoms with no element, several elements)."""


class RMSDError(GroanError):
    """reference: errors.rs RMSDError."""


class HBondError(GroanError):
    """reference: errors.rs HBondError (codes EmptyChain, NonexistentChain,
    PairSpecifiedMultipleTimes, UnusedChain, SelectError,
    InvalidSelection, InvalidMethod, InvalidWire)."""


class CellGridError(GroanError):
    """reference: errors.rs CellGridError (codes InvalidSimBox,
    InvalidCellSize, GroupError, InvalidPosition)."""


class GridMapError(GroanError):
    """reference: errors.rs GridMapError (codes InvalidSpan,
    InvalidGridTile, InvalidNumberOfValues, InvalidDataOrder, OutOfRange,
    FileNotFound, CouldNotParseLine, EmptyFile, NotIncreasing,
    InvalidCoordinates, Redefinition, Incomplete)."""


class FileTypeError(GroanError):
    """Unknown or unsupported file type (reference: files.rs)."""


class ParallelError(GroanError):
    """Errors surfaced from the parallel pass engine."""


class PerformanceWarning(UserWarning):
    """A usage pattern that pays per-call costs the batched pass avoids
    (System analysis methods looped over trajectory frames instead of
    `models.TrajectoryAnalysis`)."""
