"""GridMap: generic 2D tile map (reference: `src/structures/gridmap.rs:52`).

The port's own copy of `groan_rs_tpu/core/gridmap.py` (host numpy, no
device code), so that the port imports nothing of the JAX package.  A 2D
accumulator over (x, y) spans with fixed tile dimensions, a converter for
display values, text-file round-trip (row- and column-major, the
reference's `DataOrder`, gridmap.rs:22), and a vectorized `accumulate`
that bins whole `[N, 2]` coordinate batches at once (2D histogram — the
device path, `models.densmap`, scatter-adds on the System's device
instead of the reference's per-point `get_mut_at`).
"""

from __future__ import annotations

import math

import numpy as np

from ..errors import GridMapError


class GridMap:
    def __init__(self, span_x, span_y, tile_dim, converter=None, dtype=np.float64):
        nx = self._get_len(span_x, tile_dim[0])
        ny = self._get_len(span_y, tile_dim[1])
        self.span_x = (float(span_x[0]), float(span_x[1]))
        self.span_y = (float(span_y[0]), float(span_y[1]))
        self.tile_dim = (float(tile_dim[0]), float(tile_dim[1]))
        self.values = np.zeros((nx, ny), dtype=dtype)
        self.converter = converter if converter is not None else (lambda v: v)

    # ------------------------------------------------------------- construction
    @staticmethod
    def _get_len(span, tile) -> int:
        """reference: gridmap.rs get_len."""
        diff = span[1] - span[0]
        if diff < 0.0:
            raise GridMapError("invalid span (end before start)", code="InvalidSpan")
        if tile > diff or tile == 0.0:
            raise GridMapError("invalid tile dimension", code="InvalidGridTile")
        return int(round(diff / tile)) + 1

    @classmethod
    def from_box(cls, simbox, tile_dim, converter=None, dtype=np.float64):
        """reference: gridmap.rs from_box."""
        return cls((0.0, simbox.x), (0.0, simbox.y), tile_dim, converter, dtype)

    @classmethod
    def from_vec(cls, span_x, span_y, tile_dim, values, data_order="row",
                 converter=None):
        """Build from a flat value list (reference: gridmap.rs:492).

        `data_order`: 'row' (x outer, matches `extract_raw`) or 'column'."""
        arr = np.asarray(values)
        gm = cls(span_x, span_y, tile_dim, converter, dtype=arr.dtype)
        nx, ny = gm.n_tiles_x(), gm.n_tiles_y()
        if arr.size != nx * ny:
            raise GridMapError(
                f"expected {nx * ny} values, got {arr.size}",
                code="InvalidNumberOfValues")
        if data_order == "row":
            # copy: a reshape view would alias the caller's array and
            # clear()/set_at would silently corrupt it (and vice versa)
            gm.values = arr.reshape(nx, ny).copy()
        elif data_order == "column":
            gm.values = arr.reshape(ny, nx).T.copy()
        else:
            raise GridMapError(f"unknown data order '{data_order}'",
                               code="InvalidDataOrder")
        return gm

    # ------------------------------------------------------------- geometry
    def n_tiles_x(self) -> int:
        return self.values.shape[0]

    def n_tiles_y(self) -> int:
        return self.values.shape[1]

    def n_tiles(self) -> int:
        """Total tile count (reference: gridmap.rs:533)."""
        return int(self.values.size)

    def clear(self):
        """Reset every tile to the default value (reference: gridmap.rs:525)."""
        self.values.fill(0)

    def is_inside(self, x: float, y: float) -> bool:
        """reference: gridmap.rs:566."""
        return self._coord2index(x, y) is not None

    def get_tile(self, x: float, y: float):
        """Coordinates of the tile containing the point, or None outside
        the map (reference: gridmap.rs:553)."""
        idx = self._coord2index(x, y)
        if idx is None:
            return None
        return (self.index2x(idx[0]), self.index2y(idx[1]))

    def index2x(self, i: int) -> float:
        return self.span_x[0] + i * self.tile_dim[0]

    def index2y(self, j: int) -> float:
        return self.span_y[0] + j * self.tile_dim[1]

    def _coord2index(self, x: float, y: float):
        i = round((x - self.span_x[0]) / self.tile_dim[0])
        j = round((y - self.span_y[0]) / self.tile_dim[1])
        if not (0 <= i < self.n_tiles_x()) or not (0 <= j < self.n_tiles_y()):
            return None
        return int(i), int(j)

    # ------------------------------------------------------------- access
    def get_at(self, x: float, y: float):
        idx = self._coord2index(x, y)
        return None if idx is None else self.values[idx]

    def get_at_convert(self, x: float, y: float):
        """Converted (display) value at the coordinates, or None outside
        the map (reference: gridmap.rs:594)."""
        v = self.get_at(x, y)
        return None if v is None else self.converter(v)

    def set_at(self, x: float, y: float, value):
        idx = self._coord2index(x, y)
        if idx is None:
            raise GridMapError(f"coordinates ({x}, {y}) outside the map", code="OutOfRange")
        self.values[idx] = value

    def add_at(self, x: float, y: float, value=1):
        idx = self._coord2index(x, y)
        if idx is not None:
            self.values[idx] += value

    def accumulate(self, xy: np.ndarray, weights=None):
        """Bin an [N, 2] batch of coordinates (vectorized scatter-add)."""
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        i = np.round((xy[:, 0] - self.span_x[0]) / self.tile_dim[0]).astype(np.int64)
        j = np.round((xy[:, 1] - self.span_y[0]) / self.tile_dim[1]).astype(np.int64)
        ok = (i >= 0) & (i < self.n_tiles_x()) & (j >= 0) & (j < self.n_tiles_y())
        w = np.ones(xy.shape[0]) if weights is None else np.asarray(weights, np.float64)
        np.add.at(self.values, (i[ok], j[ok]), w[ok])
        return self

    # ------------------------------------------------------------- iteration
    def extract_raw(self):
        """Row-major (x outer) iteration of (x, y, raw) (gridmap.rs:638)."""
        for i in range(self.n_tiles_x()):
            for j in range(self.n_tiles_y()):
                yield (self.index2x(i), self.index2y(j), self.values[i, j])

    def extract_raw_column_major(self):
        for j in range(self.n_tiles_y()):
            for i in range(self.n_tiles_x()):
                yield (self.index2x(i), self.index2y(j), self.values[i, j])

    def extract_convert(self):
        for x, y, v in self.extract_raw():
            yield (x, y, self.converter(v))

    def extract_convert_column_major(self):
        for x, y, v in self.extract_raw_column_major():
            yield (x, y, self.converter(v))

    # ------------------------------------------------------------- writing
    def write_map(self, fh, column_major: bool = False):
        """reference: gridmap.rs:625 — `{:10.6} {:10.6} {value}` lines."""
        it = self.extract_convert_column_major() if column_major else self.extract_convert()
        for x, y, v in it:
            fh.write(f"{x:10.6f} {y:10.6f} {v}\n")

    def write_map_column_major(self, fh):
        """reference: gridmap.rs write_map_column_major."""
        self.write_map(fh, column_major=True)

    def write_map_raw(self, fh, column_major: bool = False):
        """Raw (unconverted) values (reference: gridmap.rs:601)."""
        it = (self.extract_raw_column_major() if column_major
              else self.extract_raw())
        for x, y, v in it:
            fh.write(f"{x:10.6f} {y:10.6f} {v}\n")

    def write_map_raw_column_major(self, fh):
        """reference: gridmap.rs:613."""
        self.write_map_raw(fh, column_major=True)

    def save(self, filename, column_major: bool = False):
        with open(filename, "w") as fh:
            self.write_map(fh, column_major)

    # ------------------------------------------------------------- reading
    @classmethod
    def from_file(cls, filename, converter=None, split=("|",), parser=float,
                  comments=("#", "@"), dtype=np.float64):
        """Parse the reference's gridmap text format (gridmap.rs:223):
        lines of `x <sep> y <sep> values...`; row- or column-major order is
        auto-detected; inconsistent spacing or redefinition is an error."""
        try:
            with open(filename) as fh:
                raw = fh.read().splitlines()
        except OSError:
            raise GridMapError(f"file '{filename}' was not found", code="FileNotFound") from None

        rows = []
        for line in raw:
            stripped = line.strip()
            if not stripped or any(stripped.startswith(c) for c in comments):
                continue
            for s in split:
                stripped = stripped.replace(s, " ")
            parts = stripped.split()
            if len(parts) < 2:
                raise GridMapError(f"could not parse line '{line}'", code="CouldNotParseLine")
            try:
                x, y = float(parts[0]), float(parts[1])
            except ValueError:
                raise GridMapError(f"could not parse line '{line}'", code="CouldNotParseLine") from None
            if len(parts) < 3:
                value = None
            else:
                try:
                    value = parser(" ".join(parts[2:])) if parser is not float else float(parts[2])
                except (ValueError, TypeError):
                    value = None
                if value is None and parser is not None:
                    raise GridMapError(
                        f"could not parse value in line '{line}'", code="CouldNotParseLine"
                    )
            rows.append((x, y, value))

        if not rows:
            raise GridMapError("no data lines in gridmap file", code="EmptyFile")

        xs = np.array([r[0] for r in rows])
        ys = np.array([r[1] for r in rows])

        # detect data order: which coordinate changes fastest
        if len(rows) > 1 and not math.isclose(xs[0], xs[1], abs_tol=1e-4):
            order = "column"  # x changes fastest => column-major
            fast, slow = xs, ys
        else:
            order = "row"
            fast, slow = ys, xs

        def axis_values(v):
            out = [v[0]]
            for val in v[1:]:
                if not math.isclose(val, out[-1], abs_tol=1e-4):
                    if any(math.isclose(val, o, abs_tol=1e-4) for o in out):
                        continue
                    out.append(val)
            return out

        fast_vals = sorted(set(np.round(fast, 4)))
        slow_vals = sorted(set(np.round(slow, 4)))
        if len(fast_vals) < 2 or len(slow_vals) < 1:
            raise GridMapError("all coordinates are identical", code="InvalidSpan")

        # coordinates must progress in increasing order (reference:
        # "Invalidity reason: Not Increasing", gridmap.rs file tests)
        slow_seen = []
        for v in np.round(slow, 4):
            if slow_seen and v < slow_seen[-1] and v not in slow_seen[:-1]:
                if not math.isclose(v, slow_seen[-1], abs_tol=1e-4):
                    raise GridMapError(
                        "coordinates are not increasing", code="NotIncreasing"
                    )
            if not slow_seen or v != slow_seen[-1]:
                slow_seen.append(v)
        for k in range(1, len(fast)):
            same_block = math.isclose(slow[k], slow[k - 1], abs_tol=1e-4)
            if same_block and fast[k] < fast[k - 1] - 1e-4:
                raise GridMapError(
                    "coordinates are not increasing", code="NotIncreasing"
                )

        def spacing(vals, what):
            if len(vals) < 2:
                return 1.0
            diffs = np.diff(vals)
            if not np.allclose(diffs, diffs[0], atol=1e-4):
                raise GridMapError(f"inconsistent {what} spacing", code="InvalidGridTile")
            return float(diffs[0])

        tile_fast = spacing(fast_vals, "fast-axis")
        tile_slow = spacing(slow_vals, "slow-axis")

        if order == "column":
            span_x = (fast_vals[0], fast_vals[-1])
            span_y = (slow_vals[0], slow_vals[-1])
            tile = (tile_fast, tile_slow)
        else:
            span_x = (slow_vals[0], slow_vals[-1])
            span_y = (fast_vals[0], fast_vals[-1])
            tile = (tile_slow, tile_fast)

        gm = cls(span_x, span_y, tile, converter, dtype=object if parser not in (float, None) else dtype)
        seen = set()
        for x, y, value in rows:
            idx = gm._coord2index(x, y)
            if idx is None:
                raise GridMapError(
                    f"coordinates ({x}, {y}) do not fit the grid", code="InvalidCoordinates"
                )
            if idx in seen:
                raise GridMapError(
                    f"tile ({x}, {y}) defined multiple times", code="Redefinition"
                )
            seen.add(idx)
            if value is not None:
                gm.values[idx] = value
        if len(seen) != gm.n_tiles_x() * gm.n_tiles_y():
            raise GridMapError("gridmap file does not cover the full grid", code="Incomplete")
        return gm
