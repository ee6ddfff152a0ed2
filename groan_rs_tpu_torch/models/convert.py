"""Per-frame converter/analyzer framework
(reference: `src/structures/traj_convert.rs:19-161`; port of
`groan_rs_tpu/models/convert.py`).  The converters mutate the System of
the port's per-frame iterators through its own methods, on the System's
device: `FitConverter` and `CenterConverter` reach the K1 + K2 refined
centre through them.

- `FrameConvert.convert(system)` mutates the system's current frame
  (`FrameConvert`, traj_convert.rs:30).
- `FrameAnalyze.analyze(system) -> value` computes a per-frame observable
  (`FrameAnalyze`, traj_convert.rs:76).
- `convert_iter(reader, converters)` yields the converted system per frame
  (`TrajConverter`, traj_convert.rs:19).
- `analyze_iter(reader, analyzer, converters=())` yields (system, value)
  (`TrajAnalyzer` / `TrajConverterAnalyzer`, traj_convert.rs:65,114).

Anything implementing the duck-typed protocol works; plain functions are
accepted too (a function `f(system)` is a converter; one returning a value
is an analyzer).  For batched device-side analysis prefer
`models.TrajectoryAnalysis` — this framework is the API-parity per-frame
path (trajectory writers, custom mutations).
"""

from __future__ import annotations

__all__ = ["FrameConvert", "FrameAnalyze", "convert_iter", "analyze_iter",
           "TranslateConverter", "WrapConverter", "FitConverter",
           "MakeWholeConverter", "CenterConverter", "UnwrapConverter"]


class FrameConvert:
    """Protocol: mutate the system's current frame in place."""

    def convert(self, system) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class FrameAnalyze:
    """Protocol: compute a per-frame observable."""

    def analyze(self, system):  # pragma: no cover - interface
        raise NotImplementedError


def _as_converter(c):
    if hasattr(c, "convert"):
        return c.convert
    return c


def convert_iter(reader, converters=()):
    """Apply converters to every frame of a reader, yielding the system."""
    fns = [_as_converter(c) for c in converters]
    for system in reader:
        for fn in fns:
            fn(system)
        yield system


def analyze_iter(reader, analyzer, converters=()):
    """Yield (system, analysis_value) per frame, after conversion."""
    an = analyzer.analyze if hasattr(analyzer, "analyze") else analyzer
    for system in convert_iter(reader, converters):
        yield system, an(system)


# ------------------------------------------------------------- converters

class TranslateConverter(FrameConvert):
    """Translate all atoms by a vector each frame (PBC wrap)."""

    def __init__(self, vector):
        self.vector = vector

    def convert(self, system) -> None:
        system.atoms_translate(self.vector)


class WrapConverter(FrameConvert):
    """Wrap all atoms into the box each frame."""

    def convert(self, system) -> None:
        system.atoms_wrap()


class FitConverter(FrameConvert):
    """RMSD-fit every frame onto a reference structure
    (reference: RMSDConverter semantics via calc_rmsd_and_fit)."""

    def __init__(self, reference, group: str):
        self.reference = reference
        self.group = group

    def convert(self, system) -> None:
        system.calc_rmsd_and_fit(self.reference, self.group)


class MakeWholeConverter(FrameConvert):
    """Fix molecules broken across PBC each frame (`gmx trjconv -pbc whole`;
    per-frame form of `System.make_molecules_whole`, modifying.rs:338)."""

    def convert(self, system) -> None:
        system.make_molecules_whole()


class CenterConverter(FrameConvert):
    """Center a group in the box each frame (`gmx trjconv -center`;
    per-frame form of `System.atoms_center[_mass]`, utility.rs:109,168)."""

    def __init__(self, group: str, dimension=None, mass_weighted: bool = False):
        from ..core.dimension import Dimension

        self.group = group
        self.dimension = Dimension.XYZ if dimension is None else dimension
        self.mass_weighted = mass_weighted

    def convert(self, system) -> None:
        if self.mass_weighted:
            system.atoms_center_mass(self.group, self.dimension)
        else:
            system.atoms_center(self.group, self.dimension)


class UnwrapConverter(FrameConvert):
    """Remove box jumps between consecutive frames
    (`gmx trjconv -pbc nojump`; surpass — the reference has no unwrapper).

    Stateful: the first converted frame is taken as-is; every later frame's
    raw displacement from the previous raw frame is taken through the
    minimum image (fractional-space rounding, so any triclinic box is exact)
    and accumulated onto the unwrapped path — the same
    displacement-accumulation semantics as `ops.msd.unwrap_orthorhombic`
    (each step min-imaged with ITS OWN box, so NPT box changes are handled),
    whose output this matches on orthorhombic boxes.  Assumes frame-to-frame
    motion < half a box vector — the standard MSD sampling assumption.
    """

    def __init__(self):
        self._prev_raw = None
        self._prev_unwrapped = None

    def convert(self, system) -> None:
        import numpy as np

        from ..errors import SimBoxError

        sb = system.simbox
        if sb is None or sb.is_zero():
            raise SimBoxError("system has no simulation box",
                              code="DoesNotExist")
        if not sb.is_valid():
            raise SimBoxError("simulation box is not valid", code="Invalid")
        h = sb.to_matrix().astype(np.float64)
        # rows of `h` are the box vectors: cartesian = fractional @ h
        raw = system.positions.astype(np.float64)
        if self._prev_raw is not None:
            d = raw - self._prev_raw
            d -= np.round(d @ np.linalg.inv(h)) @ h
            self._prev_unwrapped = self._prev_unwrapped + d
            self._prev_raw = raw
            system.positions = self._prev_unwrapped.astype(np.float32)
        else:
            self._prev_raw = raw
            self._prev_unwrapped = raw
