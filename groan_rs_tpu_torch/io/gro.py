"""GRO structure reading/writing.

Port of `groan_rs_tpu/io/gro.py` (the same vectorised byte-matrix reader
and printf-exact writer; the writers give the JAX package's bytes).
reference: `src/io/gro_io/structure.rs:120` (reader), `:41` + `mod.rs:72-140`
(writer).  Fixed-column layout: resid [0:5], resname [5:10], atomname
[10:15], atomnum [15:20], position 3 x 8 chars from col 20 (3 decimals),
optional velocity 3 x 8 chars from col 44 (4 decimals).  Box line: 3 or 9
whitespace-separated floats; v1y/v1z/v2z must be zero (Gromacs convention).
"""

from __future__ import annotations

import math

import numpy as np

from ..core.simbox import SimBox
from ..core.topology import Topology
from ..errors import ParseGroError, WriteGroError
from ..utils.textcols import FixedWidthLines

#: supported coordinate range (reference: auxiliary.rs:24-29)
GRO_MIN_COORDINATE = -999.0
GRO_MAX_COORDINATE = 9999.0


def parse_box_line(line: str) -> SimBox:
    """reference: gro_io/mod.rs line_as_box."""
    parts = line.split()
    try:
        vals = [float(p) for p in parts]
    except ValueError:
        raise ParseGroError(f"could not parse box line '{line.rstrip()}'") from None
    if len(vals) not in (3, 9):
        raise ParseGroError(f"box line has {len(vals)} values (expected 3 or 9)")
    if not all(math.isfinite(v) for v in vals):
        raise ParseGroError(f"box line contains non-finite value: '{line.rstrip()}'")
    if len(vals) == 9 and (vals[3] != 0.0 or vals[4] != 0.0 or vals[6] != 0.0):
        raise ParseGroError(
            f"unsupported box shape (v1y/v1z/v2z must be zero): '{line.rstrip()}'",
            code="UnsupportedBox",
        )
    return SimBox.from_gro_line(vals)


def parse_atom_block(lines, fw: FixedWidthLines | None = None):
    """Parse GRO atom lines -> (topology columns + positions/velocities).

    Vectorized over all lines at once (the reference's per-line
    `line_as_atom`, gro_io/structure.rs:165, run as numpy column ops).
    `lines` may be a list of strings, or pass a prebuilt byte-matrix `fw`
    (the zero-Python-strings fast path of `read_gro`).
    """
    if fw is None:
        fw = FixedWidthLines(lines)
    lengths = fw.line_lengths()
    if fw.n and int(lengths.min()) < 44:
        i = int(np.argmin(lengths))
        bad = (lines[i] if lines is not None
               else fw.mat[i].tobytes().decode(errors="replace"))
        raise ParseGroError(f"could not parse line '{bad.rstrip()}' as atom")

    resnum = fw.col_int(0, 5, "residue number", ParseGroError)
    resname = fw.col_str_bytes(5, 10)   # S-dtype: interning stays byte-level
    atomname = fw.col_str_bytes(10, 15)
    atomnum = fw.col_int(15, 20, "atom number", ParseGroError)

    if (np.char.str_len(resname) == 0).any() or (np.char.str_len(atomname) == 0).any():
        raise ParseGroError("empty residue or atom name")
    if (resnum < 0).any() or (atomnum < 0).any():
        raise ParseGroError("negative residue or atom number")

    pos = np.stack(
        [fw.col_float(20 + 8 * i, 28 + 8 * i, "position", ParseGroError) for i in range(3)],
        axis=1,
    ).astype(np.float32)
    if not np.isfinite(pos).all():
        raise ParseGroError("position is not finite", code="InvalidFloat")

    has_velocity = lengths >= 68
    velocities = None
    if has_velocity.all():
        vel = np.stack(
            [fw.col_float(44 + 8 * i, 52 + 8 * i, "velocity", ParseGroError) for i in range(3)],
            axis=1,
        ).astype(np.float32)
        if not np.isfinite(vel).all():
            raise ParseGroError("velocity is not finite", code="InvalidFloat")
        velocities = vel
    elif has_velocity.any():
        # mixed: parse per-line (rare)
        vel = np.zeros((fw.n, 3), dtype=np.float32)
        for i in np.nonzero(has_velocity)[0]:
            line = (lines[i] if lines is not None
                    else fw.mat[i].tobytes().decode(errors="replace"))
            for k in range(3):
                try:
                    vel[i, k] = float(line[44 + 8 * k : 52 + 8 * k])
                except ValueError:
                    raise ParseGroError(
                        f"could not parse line '{line.rstrip()}' as atom"
                    ) from None
        velocities = vel

    return resnum, resname, atomname, atomnum, pos, velocities, has_velocity


def read_gro(filename):
    """Read a GRO file into a System (reference: gro_io/structure.rs:120)."""
    from ..system import System

    try:
        with open(filename, "rb") as fh:
            data = fh.read()
    except OSError:
        raise ParseGroError(f"file '{filename}' was not found", code="FileNotFound") from None

    # header: title + atom count (only these become Python strings; the
    # atom block parses as one byte matrix)
    p1 = data.find(b"\n")
    p2 = data.find(b"\n", p1 + 1) if p1 >= 0 else -1
    if p1 < 0 or p2 < 0:
        raise ParseGroError(f"missing lines in '{filename}'", code="LineNotFound")
    title = data[:p1].decode(errors="replace").strip()
    try:
        n_atoms = int(data[p1 + 1 : p2].strip())
    except ValueError:
        raise ParseGroError(
            f"could not parse '{data[p1 + 1 : p2].decode(errors='replace').strip()}' "
            "as number of atoms") from None

    # slice the atom block exactly (its lines are uniform-width, so the
    # byte matrix is a zero-copy reshape); the box line follows it
    arr = np.frombuffer(data, np.uint8)
    nl = np.flatnonzero(arr[p2 + 1 :] == 0x0A) + p2 + 1
    if len(nl) < n_atoms:
        raise ParseGroError(f"missing line(s) in '{filename}'", code="LineNotFound")

    if n_atoms:
        atom_end = int(nl[n_atoms - 1])
        fw_atoms = FixedWidthLines.from_bytes(data[p2 + 1 : atom_end + 1])
        resnum, resname, atomname, atomnum, pos, vel, has_vel = parse_atom_block(
            None, fw=fw_atoms)
        box_start = atom_end + 1
    else:
        box_start = p2 + 1
    box_end = int(nl[n_atoms]) if len(nl) > n_atoms else len(data)
    if box_start >= len(data):
        raise ParseGroError(f"missing line(s) in '{filename}'", code="LineNotFound")
    if not n_atoms:
        resnum = np.empty(0, np.int64)
        resname = atomname = np.empty(0, object)
        atomnum = np.empty(0, np.int64)
        pos = np.empty((0, 3), np.float32)
        vel, has_vel = None, np.empty(0, bool)

    simbox = parse_box_line(
        data[box_start:box_end].decode(errors="replace").rstrip("\r"))

    topo = Topology.from_columns(resnum, resname, atomname, atomnum)
    return System(
        name=title,
        topology=topo,
        simbox=None if simbox.is_zero() else simbox,
        positions=pos,
        velocities=vel,
        has_velocity=has_vel if vel is not None else None,
    )


# ---------------------------------------------------------------- writing

def _fmt_fixed(vals: np.ndarray, width: int, decimals: int) -> np.ndarray:
    """printf("%{width}.{decimals}f") of float32 values, vectorized as
    integer digit extraction -> uint8 matrix [n, width].

    Bit-exact vs printf: a float32 times 10^decimals (<= 4) fits float64
    exactly (24+14 < 53 bits), so half-even rint decides the same digit
    printf's exact-decimal rounding does; the sign of a value rounding to
    zero follows the sign bit ("-0.000"), like printf.
    """
    v64 = vals.astype(np.float64).reshape(-1)
    scale = 10 ** decimals
    i = np.rint(v64 * scale).astype(np.int64)
    neg = np.signbit(v64)
    a = np.abs(i)
    n = a.shape[0]
    out = np.full((n, width), 0x20, np.uint8)
    col = width - 1
    for k in range(decimals):  # fraction digits, right to left
        out[:, col] = 0x30 + (a % 10).astype(np.uint8)
        a //= 10
        col -= 1
    out[:, col] = 0x2E  # '.'
    col -= 1
    out[:, col] = 0x30 + (a % 10).astype(np.uint8)  # at least one int digit
    a //= 10
    col -= 1
    first_digit = np.full(n, col + 1, np.int64)
    while col >= 0:
        more = a > 0
        if not more.any():
            break
        d = (a % 10).astype(np.uint8)
        out[more, col] = 0x30 + d[more]
        first_digit[more] = col
        a //= 10
        col -= 1
    if (a > 0).any():
        raise WriteGroError("coordinate too large for GRO format",
                            code="CoordinateTooLarge")
    sign_col = first_digit - 1
    if (neg & (sign_col < 0)).any():
        raise WriteGroError("coordinate too large for GRO format",
                            code="CoordinateTooLarge")
    rows = np.nonzero(neg)[0]
    out[rows, sign_col[rows]] = 0x2D  # '-'
    return out


def _fmt_int(vals: np.ndarray, width: int) -> np.ndarray:
    """printf("%{width}d") of non-negative ints -> uint8 matrix."""
    a = np.asarray(vals, np.int64).copy()
    n = a.shape[0]
    out = np.full((n, width), 0x20, np.uint8)
    col = width - 1
    out[:, col] = 0x30 + (a % 10).astype(np.uint8)
    a //= 10
    col -= 1
    while col >= 0 and (a > 0).any():
        more = a > 0
        d = (a % 10).astype(np.uint8)
        out[more, col] = 0x30 + d[more]
        a //= 10
        col -= 1
    return out


def format_atom_blob(system, indices, write_velocities: bool) -> bytes:
    """Vectorized GRO atom-line formatting -> one newline-joined byte blob
    (reference: atom.rs:556).  All fields render through printf formats
    (np.char.mod) and compose as a fixed-width byte matrix — no per-line
    Python strings."""
    topo = system.topology
    idx = np.asarray(indices)
    n = idx.shape[0]
    pos = np.where(
        system.has_position[idx, None], system.positions[idx], np.float32(0.0)
    )
    if ((pos < GRO_MIN_COORDINATE) | (pos > GRO_MAX_COORDINATE)).any():
        raise WriteGroError("coordinate too large for GRO format", code="CoordinateTooLarge")

    resnum = topo.resnum[idx] % 100_000
    atomnum = topo.atomnum[idx] % 100_000

    def name_bytes(values, just):
        b = values.astype("S5")  # truncate to 5 (reference truncation)
        b = np.char.ljust(b, 5) if just == "l" else np.char.rjust(b, 5)
        view = b.view(np.uint8).reshape(n, 5)
        return np.where(view == 0, np.uint8(0x20), view)

    mats = [
        _fmt_int(resnum, 5),
        name_bytes(topo.resname.values()[idx], "l"),
        name_bytes(topo.atomname.values()[idx], "r"),
        _fmt_int(atomnum, 5),
    ]
    mats.extend(_fmt_fixed(pos[:, k], 8, 3) for k in range(3))
    if write_velocities:
        vel = np.where(
            system.has_velocity[idx, None], system.velocities[idx], np.float32(0.0)
        )
        mats.extend(_fmt_fixed(vel[:, k], 8, 4) for k in range(3))

    total = sum(m.shape[1] for m in mats) + 1  # + newline
    mat = np.empty((n, total), np.uint8)
    off = 0
    for m in mats:
        mat[:, off : off + m.shape[1]] = m
        off += m.shape[1]
    mat[:, -1] = 0x0A
    return mat.tobytes()


def format_atom_lines(system, indices, write_velocities: bool) -> list[str]:
    """The lines of `format_atom_blob`, one str per atom."""
    blob = format_atom_blob(system, indices, write_velocities)
    return blob.decode().split("\n")[:-1]


def format_box_line(simbox: SimBox | None) -> str:
    """reference: gro_io/mod.rs write_box."""
    if simbox is None:
        return f" {0.0:9.5f} {0.0:9.5f} {0.0:9.5f}"
    if simbox.is_orthogonal():
        return f" {simbox.x:9.5f} {simbox.y:9.5f} {simbox.z:9.5f}"
    v = list(iter(simbox))
    return " " + " ".join(f"{x:9.5f}" for x in v)


def frame_title(system, group: str, is_trajectory: bool) -> str:
    """reference: gro_io/mod.rs determine_title."""
    title = system.get_name() if group == "all" else f"Group `{group}` from {system.get_name()}"
    if is_trajectory:
        return f"{title} t={_fmt_f32(system.get_time())} step={system.get_step()}"
    return title


def _fmt_f32(v: float) -> str:
    """Rust f32 Display-like shortest formatting."""
    f = np.float32(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(float(np.float32(v)))


def write_gro_frame(system, fh, group: str, write_velocities: bool,
                    is_trajectory: bool = False):
    """One frame: of a structure file, or of a trajectory (the title then
    carries the time and step)."""
    indices = system.group_indices(group)
    fh.write(frame_title(system, group, is_trajectory) + "\n")
    fh.write(f"{len(indices):>5}\n")
    fh.write(format_atom_blob(system, indices, write_velocities).decode())
    fh.write(format_box_line(system.get_box()) + "\n")


def write_gro(system, filename, group: str = "all", write_velocities: bool = False):
    """reference: System::write_gro / group_write_gro (gro_io/structure.rs:41-116)."""
    if not system.group_exists(group):
        raise WriteGroError(f"group '{group}' does not exist", code="GroupNotFound")
    try:
        with open(filename, "w") as fh:
            write_gro_frame(system, fh, group, write_velocities)
    except OSError:
        raise WriteGroError(f"could not create file '{filename}'", code="CouldNotCreate") from None
