"""Axis-mask dimension type (port of `groan_rs_tpu/core/dimension.py`).

The reference's 8-way `Dimension` enum (`src/structures/dimension.rs:15`):
each variant's value is a static boolean 3-mask, which the PBC distance
takes as its `dim_mask`.
"""

from __future__ import annotations

import enum

import numpy as np


class Dimension(enum.Enum):
    NONE = (False, False, False)
    X = (True, False, False)
    Y = (False, True, False)
    Z = (False, False, True)
    XY = (True, True, False)
    XZ = (True, False, True)
    YZ = (False, True, True)
    XYZ = (True, True, True)

    # ------------------------------------------------------------------ queries
    @property
    def is_x(self) -> bool:
        return self.value[0]

    @property
    def is_y(self) -> bool:
        return self.value[1]

    @property
    def is_z(self) -> bool:
        return self.value[2]

    @property
    def is_none(self) -> bool:
        return self is Dimension.NONE

    @property
    def n_axes(self) -> int:
        return sum(self.value)

    # ------------------------------------------------------------------ conversions
    def mask(self, dtype=np.float32) -> np.ndarray:
        """The `(3,)` axis mask as a numpy array."""
        return np.array(self.value, dtype=dtype)

    def to_unit_vector(self) -> np.ndarray:
        """Unit vector along the dimension's diagonal (reference:
        `impl From<Dimension> for Vector3D`: XY gives [1/sqrt2, 1/sqrt2, 0],
        XYZ [1/sqrt3] * 3, NONE zeros)."""
        m = self.mask(np.float32)
        n = m.sum()
        if n == 0:
            return m
        return m / np.float32(np.sqrt(n))

    @classmethod
    def from_string(cls, s: str) -> "Dimension":
        key = s.strip().upper()
        if key in ("", "NONE"):
            return cls.NONE
        try:
            return cls[key]
        except KeyError:
            from ..errors import DimensionError

            raise DimensionError(f"'{s}' is not a valid dimension") from None

    @classmethod
    def from_flags(cls, x: bool, y: bool, z: bool) -> "Dimension":
        return cls((bool(x), bool(y), bool(z)))

    def __str__(self) -> str:
        return self.name.lower()
