"""Trajectory reading and writing.

Port of `groan_rs_tpu/io/traj.py` (`FrameBatch` :45-107, the sources
:168-392, `TrajReader` :418-891, the loader :894-958,
`RMSDTrajIterator` :960-1050, the entry points :1062-1118 and the writers
:1125-1268):

- A source scans its file's frame index once (offsets, steps, times):
  `XtcSource` (the native codec, or the pure-Python one of `io/xtc_py.py`
  under ``GROAN_XTC_BACKEND=py``, which reads the f32 wire only),
  `TrrSource`, `GroSource` (a multi-frame GRO, parsed per requested batch
  with per-atom velocities), `TngSource` (`io/tng.py`) and the DCD,
  Amber NetCDF, LAMMPS dump, XYZ and MOL2 sources of `io/chem.py`.
- `TrajReader` holds one frame table over one file or several
  concatenated ones: equal times are dropped only at a file boundary
  (duplicates inside one file stay, traj_cat.rs:229-260).  `with_range`
  keeps the frames within `TIME_PRECISION` of a time range and
  `with_step` every n-th frame; the two commute, as the reference's
  adapters do (traj_read.rs:301-514).
- `batches(wire=...)` yields `[B, K, 3]` numpy `FrameBatch`es decoded in
  bulk by the native codec on a background thread, one batch ahead of
  the consumer.  A batch that straddles two files is read as f32 per
  part and concatenated; TRR and GRO batches are f32 and carry the
  velocities (and a TRR batch the forces, when its frames have them).
- A selection (`group=` or `indices=`) decodes only up to its last atom
  (`stop_after`: the partial-frame early stop of molly_xtc.rs:58-63, a
  byte-range read for TRR) and is then gathered — as a slice when
  contiguous, a no-op when it is the decoded prefix.
- Wires (JAX `:621-760`): "f32" (float32 positions, 12 B per atom), "q16"
  (raw quantized int16, 6 B; `pos = float32(q) * (1 / precision)` on the
  device is bit-identical to the float decode), "delta" (int8
  inter-frame deltas, ~3 B, with a per-frame drift and sparse escapes)
  and "delta6" (6-bit packed deltas, 2.25 B).  A delta chain starts with a
  key frame (`base_q`) and carries on through the chunks of one file; the
  engine rebuilds the integers on the device.  "auto" asks for the
  smallest wire each chunk fits, down the ladder delta6 -> delta -> q16
  -> f32: a chunk that does not fit a tier (DeltaRange, Q16Range) drops
  to the next, and the pass stays there (hysteresis).  "delta6" and
  "delta" enter the ladder at their tier, "q16" at q16.  A chain restarts
  with a key frame at the first chunk of each file and after a fall.
  The delta decoders gather a selection inside the codec.  Chunks decode
  in order on the prefetch thread (the chain runs through them).  TRR,
  GRO and the other formats, and ``GROAN_XTC_BACKEND=py``, read f32
  whatever the wire.  `GROAN_WIRE`, when set, overrides the caller's
  wire, as in the JAX reader; an unknown wire raises `InvalidWire`.
- `XtcSource(path, use_index_cache=True)` keeps its scanned frame index in
  the cache of `io/index_cache.py` and reads it back while the file is
  unchanged.
- Iterating a `TrajReader` yields the System once per frame, holding
  that frame's positions, velocities, forces, box, step, time and
  precision (JAX `io/traj.py:822-891`); `read_frames` reads frames by
  number as one f32 batch (`:588`).  `calc_rmsd` / `calc_rmsd_and_fit`
  yield (System, RMSD) per frame, computed per batch on the System's
  device (`RMSDTrajIterator`).
- `print_progress` ticks a `ProgressPrinter` as batches are handed out:
  every frame counts (printed every `print_freq` frames), then COMPLETED,
  or FAILED when reading fails.  (The JAX runner attaches the printer but
  its batch path prints nothing.)
- Writers (`make_writer`): XTC and TRR through the port's codec, GRO
  trajectories, TNG (`io/tng.py`: gzip or the XTC2 codec) and extended
  XYZ, each of a group snapshotted at creation, byte-identical to the JAX
  writers (a TNG file up to its creation time and program name).
"""

from __future__ import annotations

import os
import re
import threading
import time
from dataclasses import dataclass

import numpy as np

from ..core.simbox import SimBox
from ..errors import ReadTrajError, WriteTrajError
from ..files import FileType
from ..progress import ProgressPrinter, ProgressStatus
from ..utils import profiling as prof
from . import native

__all__ = ["TIME_PRECISION", "FrameBatch", "FrameSource", "XtcSource", "TrrSource", "GroSource",
           "open_source", "TrajReader", "RMSDTrajIterator", "traj_iter", "xtc_iter",
           "trr_iter", "gro_iter", "tng_iter", "cat_iter", "TrajWriter", "XtcWriter",
           "TrrWriter", "GroTrajWriter", "TngTrajWriter", "XyzTrajWriter",
           "make_writer"]

TIME_PRECISION = 0.001  # reference: molly_xtc.rs:30
WIRES = ("f32", "q16", "delta", "delta6", "auto")

# (row, column) of each gro-order box component in the row-major matrix
_GRO_ORDER = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 0), (1, 2), (2, 0),
              (2, 1))


@dataclass
class FrameBatch:
    """A decoded batch of frames (host numpy).  On the delta wires
    `positions` holds the deltas (int8 [B, K, 3] for "delta", packed uint8
    [B, ceil(3K / 4) * 3] for "delta6"), `wire_natoms` the atom count K,
    `shifts` [B, 3] int32 the per-frame drift, `esc_idx` [B, E] int32 and
    `esc_val` [B, E, 3] int16/int32 the escapes (index K: padding) and
    `base_q` [K, 3] int16/int32 the key frame that restarts the chain
    (None while the chain carries on)."""

    positions: np.ndarray  # [B, K, 3] f32 / int16, or the delta payload
    boxes9: np.ndarray  # [B, 9] gro-order box components
    steps: np.ndarray  # [B] int64
    times: np.ndarray  # [B] float32
    frame_numbers: np.ndarray  # [B] frame indices in the iteration
    precisions: np.ndarray | None = None  # [B] float32
    velocities: np.ndarray | None = None  # [B, K, 3] float32 (TRR, GRO)
    forces: np.ndarray | None = None  # [B, K, 3] float32 (TRR)
    has_x: np.ndarray | None = None  # [B] bool (TRR frames may lack blocks)
    has_v: np.ndarray | None = None
    has_f: np.ndarray | None = None
    vel_mask: np.ndarray | None = None  # [B, K] per-atom velocity presence (GRO)
    atom_indices: np.ndarray | None = None  # selection indices if partial
    wire: str = "f32"
    wire_natoms: int | None = None  # K of the delta wires
    base_q: np.ndarray | None = None  # [K, 3] key frame of a delta chain
    shifts: np.ndarray | None = None  # [B, 3] int32 per-frame drift
    esc_idx: np.ndarray | None = None  # [B, E] int32 escape atoms (K: padding)
    esc_val: np.ndarray | None = None  # [B, E, 3] escape values

    def __len__(self) -> int:
        return self.positions.shape[0]

    def box_lengths(self) -> np.ndarray:
        """[B, 3] orthogonal box lengths (v1x, v2y, v3z)."""
        return self.boxes9[:, :3]

    def box_matrices(self) -> np.ndarray:
        """[B, 3, 3] row-major box matrices (rows are the box vectors)."""
        out = np.zeros((self.boxes9.shape[0], 3, 3), np.float32)
        for k, (i, j) in enumerate(_GRO_ORDER):
            out[:, i, j] = self.boxes9[:, k]
        return out


def _xtc_box_to_gro9(box33: np.ndarray) -> np.ndarray:
    """[F, 9] row-major 3x3 (XTC/TRR storage) -> gro-order 9-vector."""
    b = box33.reshape(-1, 3, 3)
    return np.stack([b[:, i, j] for i, j in _GRO_ORDER], axis=1).astype(np.float32)


def _pad_escapes(ei: np.ndarray, ev: np.ndarray, k: int):
    """Widen the escape lists to a few bucket widths (a power of two from
    16 up to 1024, then multiples of 1024) so that the device sees few
    shapes; the added entries hold the index `k`, which the rebuild drops
    (JAX `io/traj.py:110-132`)."""
    e = ei.shape[1]
    if e == 0:
        tgt = 0
    elif e <= 1024:
        tgt = max(16, 1 << (e - 1).bit_length())
    else:
        tgt = -(-e // 1024) * 1024
    if tgt > e:
        ei = np.concatenate([ei, np.full((ei.shape[0], tgt - e), k, np.int32)], axis=1)
        ev = np.concatenate([ev, np.zeros((ev.shape[0], tgt - e, 3), ev.dtype)], axis=1)
    return ei, ev


def _magic_error(path, kind):
    return ReadTrajError(
        f"could not read magic number from '{path}' (empty or not an {kind} "
        "file)", code="CouldNotReadMagic")


class FrameSource:
    """A trajectory file with a scanned frame index: the base of the
    port's sources (JAX `io/traj.py:152-170`).  A source reads frames by
    index; `TrajReader` batches, concatenates and selects them."""

    kind: str
    path: str
    natoms: int
    times: np.ndarray  # f32 [F]
    steps: np.ndarray  # i64 [F]

    def n_frames(self) -> int:
        return self.times.shape[0]

    def read_batch(self, frame_ids, stop_after=None, wire: str = "f32",
                   velocities: bool = False) -> FrameBatch:
        """Frames `frame_ids` (this file's own numbering) as one batch of
        their first `stop_after` atoms, on the `wire` ("f32" or "q16")."""
        raise NotImplementedError


class XtcSource(FrameSource):
    """An XTC file with its scanned frame index, read through the native
    codec, or through the pure-Python one when ``GROAN_XTC_BACKEND=py``
    (JAX `io/traj.py:175-184`); the Python codec gives the f32 wire only
    (`native_wire` False)."""

    kind = "xtc"

    def __init__(self, path, use_index_cache: bool = True):
        """`use_index_cache`: read the frame index from the cache of
        `io/index_cache.py` while the file is unchanged, and save a fresh
        scan there."""
        from .index_cache import load_index, save_index

        self.path = str(path)
        self._codec = native
        self.native_wire = True
        if os.environ.get("GROAN_XTC_BACKEND", "native") == "py":
            from . import xtc_py

            self._codec = xtc_py
            self.native_wire = False
        cached = load_index(self.path) if use_index_cache else None
        if cached is not None:
            offsets, steps, times = (cached[k] for k in ("offsets", "steps", "times"))
            natoms = int(cached["natoms"])
        else:
            offsets, steps, times, natoms = self._codec.xtc_scan(self.path)
            if use_index_cache:
                save_index(self.path, dict(offsets=offsets, steps=steps, times=times,
                                           natoms=natoms))
        if natoms <= 0:
            raise _magic_error(self.path, "xtc")
        self.offsets = offsets
        self.steps = steps.astype(np.int64)
        self.times = times
        self.natoms = natoms

    def n_frames(self) -> int:
        return self.times.shape[0]

    def read_batch(self, frame_ids, stop_after=None, wire: str = "f32",
                   velocities: bool = False) -> FrameBatch:
        if wire == "q16" and not self.native_wire:
            raise ReadTrajError("the Python XTC codec reads the f32 wire only",
                                code="InvalidWire")
        read = native.xtc_read_frames_q16 if wire == "q16" else self._codec.xtc_read_frames
        coords, boxes, steps, times, precisions = read(
            self.path, self.offsets[frame_ids], self.natoms, stop_after=stop_after)
        return FrameBatch(
            positions=coords, boxes9=_xtc_box_to_gro9(boxes),
            steps=steps.astype(np.int64), times=times,
            frame_numbers=np.asarray(frame_ids, np.int64),
            precisions=precisions, wire=wire)


class TrrSource(FrameSource):
    """A TRR file with its scanned frame index.  Its batches are f32 and
    carry the velocities (zeros in a frame without a velocity block, as
    in the JAX package), and the forces when a frame of the batch has
    them."""

    kind = "trr"

    def __init__(self, path):
        self.path = str(path)
        offsets, steps, times, lambdas, flags, natoms = native.trr_scan(self.path)
        if natoms <= 0:
            raise _magic_error(self.path, "trr")
        self.offsets = offsets
        self.steps = steps.astype(np.int64)
        self.times = times.astype(np.float32)
        self.lambdas = lambdas
        self.flags = flags
        self.natoms = natoms

    def n_frames(self) -> int:
        return self.times.shape[0]

    def read_batch(self, frame_ids, stop_after=None, wire: str = "f32",
                   velocities: bool = True) -> FrameBatch:
        want_f = bool((self.flags[frame_ids] & 4).any())
        x, v, f, boxes, steps, times, _, flags = native.trr_read_frames(
            self.path, self.offsets[frame_ids], self.natoms, want_v=velocities,
            want_f=want_f, stop_after=stop_after)
        return FrameBatch(
            positions=x, velocities=v, forces=f, boxes9=_xtc_box_to_gro9(boxes),
            steps=steps.astype(np.int64), times=times.astype(np.float32),
            frame_numbers=np.asarray(frame_ids, np.int64),
            has_x=(flags & 1) > 0, has_v=(flags & 2) > 0, has_f=(flags & 4) > 0)


_TIME_STEP_RE = re.compile(r"t=\s*([\d\.\-]+)\s+step=\s*(\d+)")


class GroSource(FrameSource):
    """Multi-frame GRO trajectory (reference: gro_io/trajectory.rs:37).

    Construction only scans the file (each frame's byte offset, and the
    time and step of its title line); atom blocks are parsed per requested
    batch, so a large multi-frame GRO file is never held whole."""

    kind = "gro"

    def __init__(self, path):
        self.path = str(path)
        offsets, times, steps = [], [], []
        natoms = None
        try:
            fh = open(path, "rb")
        except OSError:
            raise ReadTrajError(f"file '{path}' was not found",
                                code="FileNotFound") from None
        with fh:
            while True:
                start = fh.tell()
                title = fh.readline()
                if not title:
                    break
                if not title.strip() and not fh.readline():
                    break
                if not title.strip():
                    raise ReadTrajError(f"could not parse number of atoms in '{path}'",
                                        code="FrameNotFound")
                try:
                    n = int(fh.readline().strip())
                except ValueError:
                    raise ReadTrajError(f"could not parse number of atoms in '{path}'",
                                        code="FrameNotFound") from None
                if natoms is None:
                    natoms = n
                elif natoms != n:
                    raise ReadTrajError(f"inconsistent atom count in '{path}'",
                                        code="AtomsNumberMismatch")
                for _ in range(n + 1):  # atom lines + box line
                    if not fh.readline():
                        raise ReadTrajError(f"truncated frame in '{path}'",
                                            code="FrameNotFound")
                m = _TIME_STEP_RE.search(title.decode(errors="replace"))
                if m:
                    t, st = float(m.group(1)), int(m.group(2))
                else:
                    # a title without t=/step= keeps the previous frame's
                    # values (reference: gro_io/trajectory.rs:210,340)
                    t = times[-1] if times else 0.0
                    st = steps[-1] if steps else 0
                offsets.append(start)
                times.append(t)
                steps.append(st)
        self.natoms = natoms or 0
        self._offsets = np.asarray(offsets, np.int64)
        self.times = np.asarray(times, np.float32)
        self.steps = np.asarray(steps, np.int64)

    def n_frames(self) -> int:
        return self._offsets.shape[0]

    def _parse_frame(self, fh, stop):
        from ..utils.textcols import FixedWidthLines
        from .gro import parse_atom_block, parse_box_line

        fh.readline()  # title
        n = int(fh.readline().strip())
        # one bulk read of the atom block and the box line, parsed as a
        # byte matrix (io/gro.py)
        blob = b"".join(fh.readline() for _ in range(n + 1))
        box_start = blob.rfind(b"\n", 0, len(blob) - 1) + 1
        try:
            fw = FixedWidthLines.from_bytes(blob[:box_start], n_lines=n)
            _, _, _, _, pos, vel, has_vel = parse_atom_block(None, fw=fw)
        except Exception as e:
            raise ReadTrajError(f"could not parse frame in '{self.path}': {e}",
                                code="FrameNotFound") from None
        try:
            box = parse_box_line(blob[box_start:].decode(errors="replace"))
        except Exception as e:
            raise ReadTrajError(f"invalid box in '{self.path}': {e}",
                                code="InvalidBox") from None
        box9 = np.array(list(iter(box)), np.float32)
        return (pos[:stop], (vel[:stop] if vel is not None else None),
                np.asarray(has_vel)[:stop], box9)

    def read_batch(self, frame_ids, stop_after=None, wire: str = "f32",
                   velocities: bool = True) -> FrameBatch:
        stop = stop_after if stop_after is not None else self.natoms
        ids = np.asarray(frame_ids)
        b = len(ids)
        pos = np.zeros((b, stop, 3), np.float32)
        vel = np.zeros((b, stop, 3), np.float32)
        has_v = np.zeros(b, bool)
        vel_mask = np.zeros((b, stop), bool)
        boxes = np.zeros((b, 9), np.float32)
        with open(self.path, "rb") as fh:
            for k, fid in enumerate(ids):
                fh.seek(self._offsets[fid])
                p, v, hv, box9 = self._parse_frame(fh, stop)
                pos[k] = p
                if v is not None:
                    # per-atom presence: a frame may mix lines with and
                    # without velocity columns
                    vel[k] = v
                    vel_mask[k] = hv
                    has_v[k] = bool(hv.any())
                boxes[k] = box9
        return FrameBatch(
            positions=pos, velocities=vel if velocities else None, boxes9=boxes,
            steps=self.steps[ids], times=self.times[ids],
            frame_numbers=ids.astype(np.int64), has_x=np.ones(b, bool),
            has_v=has_v, has_f=np.zeros(b, bool), vel_mask=vel_mask)


def open_source(path, fmt: str | None = None):
    """The frame source of a trajectory file (by extension unless `fmt`
    names the format): XTC, TRR, GRO, TNG, DCD, Amber NetCDF, LAMMPS dump,
    XYZ or MOL2."""
    if fmt is None:
        fmt = FileType.from_name(path).value
    if fmt == "xtc":
        return XtcSource(path)
    if fmt == "trr":
        return TrrSource(path)
    if fmt == "gro":
        return GroSource(path)
    if fmt == "tng":
        from .tng import TngSource

        return TngSource(path)
    if fmt in ("dcd", "nc", "lammpstrj", "xyz", "mol2"):
        from .chem import open_extra_source

        return open_extra_source(path, fmt)
    raise ReadTrajError(f"unsupported trajectory format '{fmt}' ('{path}')",
                        code="UnknownFormat")


def _concat(parts) -> FrameBatch:
    if len(parts) == 1:
        return parts[0]

    def cat(name):
        arrs = [getattr(p, name) for p in parts]
        return None if any(a is None for a in arrs) else np.concatenate(arrs)

    return FrameBatch(**{name: cat(name) for name in (
        "positions", "boxes9", "steps", "times", "frame_numbers", "precisions",
        "velocities", "forces", "has_x", "has_v", "has_f", "vel_mask")})


class TrajReader:
    """Batched iteration over one trajectory file or several concatenated
    ones, optionally restricted to a group or to atom `indices`."""

    def __init__(self, system, sources, group: str | None = None,
                 batch_size: int = 64, indices=None, velocities: bool = True):
        """`velocities`: read the velocity block of TRR sources."""
        self.system = system
        self.sources = list(sources)
        self.batch_size = batch_size
        self.velocities = velocities
        self.progress: ProgressPrinter | None = None
        if group is not None and indices is not None:
            raise ReadTrajError("pass either group or indices, not both",
                                code="InvalidSelection")
        natoms = self.sources[0].natoms
        for s in self.sources:
            if s.natoms != natoms:
                raise ReadTrajError(f"'{s.path}' has {s.natoms} atoms, expected "
                                    f"{natoms}", code="AtomsNumberMismatch")
        if natoms != system.get_n_atoms():
            raise ReadTrajError(
                f"trajectory '{self.sources[0].path}' has {natoms} atoms but "
                f"system has {system.get_n_atoms()}", code="AtomsNumberMismatch")
        self._sel = None
        self._stop_after = None
        if group is not None:
            self._sel = system.group_indices(group)
        elif indices is not None:
            sel = np.unique(np.asarray(indices, np.int64))
            if len(sel) and (sel[0] < 0 or sel[-1] >= natoms):
                raise ReadTrajError(
                    f"selection indices out of range [0, {natoms})",
                    code="InvalidSelection")
            self._sel = sel
        if self._sel is not None:
            self._stop_after = int(self._sel[-1]) + 1 if len(self._sel) else 0
        # a contiguous selection writes back into the System as a slice (a
        # fancy scatter of a large group costs more than its decode)
        self._sel_slice = None
        if self._sel is not None and len(self._sel) and \
                int(self._sel[-1]) - int(self._sel[0]) + 1 == len(self._sel):
            self._sel_slice = slice(int(self._sel[0]), int(self._sel[-1]) + 1)

        # the frame table: (source, local frame, time, step) per frame;
        # equal times are dropped only at a file boundary
        src = np.concatenate([np.full(s.n_frames(), i, np.int64)
                              for i, s in enumerate(self.sources)])
        local = np.concatenate([np.arange(s.n_frames()) for s in self.sources])
        times = np.concatenate([np.asarray(s.times, np.float32) for s in self.sources])
        steps = np.concatenate([s.steps for s in self.sources])
        keep = np.ones(src.shape[0], bool)
        last = None  # time of the last kept frame
        for i, s in enumerate(self.sources):
            start = int(np.searchsorted(src, i))
            run = times[start:start + s.n_frames()]
            if i and last is not None and run.shape[0]:
                # the leading frames equal to the last kept time go
                dup = np.cumprod(run == last).astype(bool)
                keep[start:start + run.shape[0]] = ~dup
                if dup.all():
                    continue  # the whole file repeats `last`
            if run.shape[0]:
                last = run[-1]
        self._src, self._local = src[keep], local[keep]
        self._times, self._steps = times[keep], steps[keep]
        self._mask = np.ones(self._times.shape[0], bool)
        # the adapters commute: with_range re-anchors the accumulated
        # stride at the range start (traj_read.rs:474)
        self._prestep_mask = self._mask.copy()
        self._step_factor = 1

    # ------------------------------------------------------------- adapters
    def _apply_step(self) -> None:
        m = np.zeros_like(self._prestep_mask)
        m[np.nonzero(self._prestep_mask)[0][::self._step_factor]] = True
        self._mask = m

    def with_range(self, start_time: float, end_time: float) -> "TrajReader":
        """Restrict to sim times in [start, end] (reference: traj_read.rs:301)."""
        if start_time < 0 or end_time < 0:
            raise ReadTrajError("range times must be non-negative", code="TimeRangeNegative")
        if start_time > end_time:
            raise ReadTrajError("range start exceeds end", code="InvalidTimeRange")
        if self.progress is not None:
            self.progress.print_jumping()
        self._prestep_mask &= ((self._times >= start_time - TIME_PRECISION)
                               & (self._times <= end_time + TIME_PRECISION))
        self._apply_step()
        if not self._mask.any():
            raise ReadTrajError(
                f"start of time range ({start_time} ps) not found in trajectory",
                code="StartNotFound")
        return self

    def with_host_shard(self, host_id: int, n_hosts: int) -> "TrajReader":
        """Keep this host's stripe of the current selection, frames
        `host_id::n_hosts`, for a multi-host pass (JAX `io/traj.py:535-558`;
        the cross-host form of the reference's per-thread striding,
        parallel.rs:425-448).  The stripe becomes the new baseline: a later
        `with_step` strides within it.  `parallel.multihost.merge_striped`
        puts the hosts' per-frame results back in frame order."""
        if not (0 <= host_id < n_hosts):
            raise ReadTrajError(
                f"host_id {host_id} not in [0, {n_hosts})", code="InvalidHostShard")
        keep = np.nonzero(self._mask)[0][host_id::n_hosts]
        mask = np.zeros_like(self._mask)
        mask[keep] = True
        self._mask = mask
        self._prestep_mask = mask.copy()
        self._step_factor = 1
        return self

    def with_step(self, step: int) -> "TrajReader":
        """Every `step`-th frame of the current selection
        (reference: traj_read.rs:394)."""
        if step == 0:
            raise ReadTrajError("step must be non-zero", code="InvalidStep")
        self._step_factor *= int(step)
        self._apply_step()
        return self

    def print_progress(self, printer: ProgressPrinter) -> "TrajReader":
        self.progress = printer
        return self

    # ------------------------------------------------------------- frame info
    def selected_frames(self) -> np.ndarray:
        return np.nonzero(self._mask)[0]

    def n_selected(self) -> int:
        return int(self._mask.sum())

    @property
    def times(self) -> np.ndarray:
        return self._times[self._mask]

    @property
    def steps(self) -> np.ndarray:
        return self._steps[self._mask]

    def read_frames(self, frame_ids) -> FrameBatch:
        """Frames of the concatenated stream by absolute number, as ONE
        float32 FrameBatch (JAX `io/traj.py:588`; the strict dense
        hydrogen-bond re-score revisits flagged frames with it)."""
        ids = np.asarray(frame_ids, np.int64)
        srcs = self._src[ids]
        parts = []
        for si in np.unique(srcs):
            part = self.sources[int(si)].read_batch(
                self._local[ids[srcs == si]], stop_after=self._stop_after,
                velocities=self.velocities)
            part.frame_numbers = ids[srcs == si]
            parts.append(part)
        out = _concat(parts)
        if self._sel is not None:
            self._gather_selection(out)
        return out

    # ------------------------------------------------------------- analyzers
    def calc_rmsd(self, reference, group: str) -> "RMSDTrajIterator":
        """Per-frame RMSD vs a reference (reference: rmsd.rs:258)."""
        return RMSDTrajIterator(self, reference, group, fit=False)

    def calc_rmsd_and_fit(self, reference, group: str) -> "RMSDTrajIterator":
        """Per-frame RMSD, every frame fitted onto the reference
        (reference: rmsd.rs:286)."""
        return RMSDTrajIterator(self, reference, group, fit=True)

    # ------------------------------------------------------------- frames
    def __iter__(self):
        """Per-frame iteration: each frame written into the System, which
        is yielded (JAX `io/traj.py:822-841`)."""
        p = self.progress
        counter = 0
        try:
            for batch in self._loader(env=False):
                for k in range(len(batch)):
                    self._update_system(batch, k)
                    if p is not None:
                        p.print(counter, self.system.get_step(), self.system.get_time())
                    counter += 1
                    yield self.system
        except Exception:
            if p is not None:
                p.set_status(ProgressStatus.FAILED)
                p.print(0, self.system.get_step(), self.system.get_time())
            raise
        if p is not None:
            p.set_status(ProgressStatus.COMPLETED)
            p.print(0, self.system.get_step(), self.system.get_time())

    def _update_system(self, batch: FrameBatch, k: int) -> None:
        """Write frame k of a batch into the System (reference:
        XtcFrameData::update_system, molly_xtc.rs:292-306): positions,
        velocities and forces (of the selection only, when there is one)
        where the frame has them, box, step, time and precision."""
        s = self.system
        sel = batch.atom_indices
        if sel is not None and self._sel_slice is not None:
            sel = self._sel_slice  # contiguous selection: slice, not scatter
        has_x = batch.has_x is None or bool(batch.has_x[k])
        has_v = batch.velocities is not None and (batch.has_v is None
                                                  or bool(batch.has_v[k]))
        has_f = batch.forces is not None and (batch.has_f is None
                                              or bool(batch.has_f[k]))
        at = slice(None) if sel is None else sel
        if has_x:
            s.positions[at] = batch.positions[k]
        s.has_position[at] = has_x
        if has_v:
            s.velocities[at] = batch.velocities[k]
            s.has_velocity[at] = (batch.vel_mask[k] if sel is None
                                  and batch.vel_mask is not None else True)
        else:
            s.has_velocity[at] = False
        if has_f and sel is None:
            s.forces[:] = batch.forces[k]
        s.has_force[at] = has_f and sel is None
        b9 = batch.boxes9[k]
        s.set_box(SimBox.from_gro_line(b9) if np.any(b9 != 0.0) else None)
        s.set_step(int(batch.steps[k]))
        s.set_time(float(batch.times[k]))
        if batch.precisions is not None and batch.precisions[k] > 0:
            s.set_precision(int(batch.precisions[k]))

    # ------------------------------------------------------------- batches
    def batches(self, batch_size: int | None = None, prefetch: bool = True,
                wire: str = "f32", deferred: bool = False):
        """Iterate FrameBatches of `batch_size` frames (the reader's own by
        default): bulk native decode, one batch decoded ahead on a
        background thread (`prefetch=False`: each batch decoded when it is
        asked for); a `print_progress` printer ticks per frame.  With
        `deferred=True` the next batch's decode waits for the loader's
        `release()` (JAX `io/traj.py:621-634`)."""
        loader = self._loader(wire, batch_size, prefetch, deferred)
        return loader if self.progress is None else self._ticked(loader)

    def _loader(self, wire: str = "f32", batch_size: int | None = None,
                prefetch: bool = True, deferred: bool = False,
                env: bool = True) -> "_PrefetchLoader":
        """`env=False`: ignore `GROAN_WIRE` (the readers of host positions:
        frame iteration, trajectory RMSD, batched hydrogen bonds)."""
        if env:
            wire = os.environ.get("GROAN_WIRE", wire)
        if wire not in WIRES:
            raise ReadTrajError(f"unknown wire format '{wire}' "
                                f"({', '.join(WIRES)})", code="InvalidWire")
        bs = batch_size or self.batch_size
        sel = self.selected_frames()
        chunks = [sel[i:i + bs] for i in range(0, len(sel), bs)]
        # the ladder's tiers still open, and the delta chain: the last
        # quantized frame of the previous chunk, its precision and file
        state = {"delta6_ok": wire in ("auto", "delta6"),
                 "delta_ok": wire in ("auto", "delta", "delta6"),
                 "q16_ok": wire in ("auto", "delta", "delta6", "q16"),
                 "prev_q": None, "prev_prec": 0.0, "prev_src": None}

        def load(chunk) -> FrameBatch:
            srcs = self._src[chunk]
            uniq = np.unique(srcs)
            if len(uniq) > 1:
                # a chunk across files reads f32 per part: the chain restarts
                state["prev_q"] = None
            parts = []
            for si in uniq:
                part = self._read_part(int(si), self._local[chunk[srcs == si]],
                                       state if len(uniq) == 1 else None)
                part.frame_numbers = chunk[srcs == si]
                parts.append(part)
            out = _concat(parts)
            if self._sel is not None and out.atom_indices is None:
                self._gather_selection(out)
            return out

        return _PrefetchLoader(load, chunks, prefetch=prefetch, deferred=deferred)

    def _read_part(self, si: int, ids, state) -> FrameBatch:
        """One source's frames on the smallest wire the state allows (JAX
        `io/traj.py:690-760`); f32 for a source without the native codec's
        compact reads, or without a state (a chunk across files)."""
        src = self.sources[si]
        kw = {"stop_after": self._stop_after, "velocities": self.velocities}
        if (state is None or not (state["delta_ok"] or state["q16_ok"])
                or src.kind != "xtc" or not getattr(src, "native_wire", False)):
            return src.read_batch(ids, wire="f32", **kw)
        if state["prev_src"] != si:
            state["prev_q"] = None  # another file: another quantization stream
        for tier, read in (("delta6", native.xtc_read_frames_delta6),
                           ("delta", native.xtc_read_frames_delta)):
            if not state[tier + "_ok"]:
                continue
            try:
                return self._read_delta(src, si, ids, tier, read, state)
            except ReadTrajError as e:
                if e.code not in ("DeltaRange", "Q16Range"):
                    raise
                # the motion does not fit this tier; later chunks would not
                # either: drop to the next one for the rest of the pass
                state[tier + "_ok"] = False
                state["prev_q"] = None
        if state["q16_ok"]:
            try:
                return src.read_batch(ids, wire="q16", **kw)
            except ReadTrajError as e:
                if e.code != "Q16Range":
                    raise
                state["q16_ok"] = False
        state["prev_q"] = None
        return src.read_batch(ids, wire="f32", **kw)

    def _read_delta(self, src, si, ids, tier, read, state) -> FrameBatch:
        """One source's frames on a delta wire, chained on from the state's
        last frame (a key frame when the chain restarts)."""
        stop = self._stop_after if self._stop_after is not None else src.natoms
        k = len(self._sel) if self._sel is not None else stop
        (payload, shifts, ei, ev, key, last, boxes, steps, times,
         precs) = read(src.path, src.offsets[ids], src.natoms, base=state["prev_q"],
                       base_prec=state["prev_prec"], stop_after=stop,
                       sel=self._sel)
        state["prev_q"], state["prev_prec"] = last, float(precs[0])
        state["prev_src"] = si
        ei, ev = _pad_escapes(ei, ev, k)
        return FrameBatch(
            positions=payload, boxes9=_xtc_box_to_gro9(boxes),
            steps=steps.astype(np.int64), times=times,
            frame_numbers=np.asarray(ids, np.int64), precisions=precs,
            wire=tier, wire_natoms=k, base_q=key, shifts=shifts, esc_idx=ei,
            esc_val=ev, atom_indices=self._sel)

    def _gather_selection(self, out: FrameBatch) -> None:
        """Compact a decoded batch to the selection: a contiguous prefix
        that the decode already stopped at is a relabel, another contiguous
        range a slice, anything else a gather."""
        sel = self._sel
        n = len(sel)
        contig = n > 0 and int(sel[-1]) - int(sel[0]) == n - 1
        if contig and int(sel[0]) == 0 and out.positions.shape[1] == n:
            ix = None
        elif contig:
            ix = slice(int(sel[0]), int(sel[0]) + n)
        else:
            ix = sel
        if ix is not None:
            out.positions = out.positions[:, ix, :]
            if out.velocities is not None:
                out.velocities = out.velocities[:, ix, :]
            if out.forces is not None:
                out.forces = out.forces[:, ix, :]
        out.atom_indices = sel

    def _ticked(self, loader):
        """`loader`'s batches, ticking the progress printer per frame."""
        p = self.progress
        counter, step, t = 0, 0, 0.0
        try:
            for fb in loader:
                for k in range(len(fb)):
                    step, t = int(fb.steps[k]), float(fb.times[k])
                    p.print(counter, step, t)
                    counter += 1
                yield fb
        except Exception:
            p.set_status(ProgressStatus.FAILED)
            p.print(0, step, t)
            raise
        p.set_status(ProgressStatus.COMPLETED)
        p.print(0, step, t)


class _PrefetchLoader:
    """Decodes chunk i+1 on one worker thread while the consumer holds
    chunk i (the native decoder releases the GIL).  One thread: chunks
    decode in order.  `prefetch=False` decodes each chunk on the
    consumer's thread when it is asked for; `deferred=True` starts the
    next chunk's decode only at `release()`.  With `utils.profiling`'s
    tracing on, each chunk's decode is a span `decode` under the span open
    where the loader was made."""

    def __init__(self, load, chunks, prefetch: bool = True, deferred: bool = False):
        self._load = load
        self._chunks = list(chunks)
        self._i = 0
        self._pending = None  # (index, thread, result box)
        self._prefetch = prefetch
        self._deferred = deferred
        self._parent = prof.current() if prof.TRACING else None
        if self._chunks and prefetch:
            self._start(0)

    def _decode(self, chunk) -> FrameBatch:
        if not prof.TRACING:
            return self._load(chunk)
        t0 = time.perf_counter()
        out = self._load(chunk)
        prof.add("decode", t0, time.perf_counter(), parent=self._parent, wire=out.wire,
                 frames=len(out))
        return out

    def release(self) -> None:
        """Start decoding the next chunk (a no-op when it already runs, or
        when no chunk is left)."""
        if self._prefetch and self._pending is None and self._i < len(self._chunks):
            self._start(self._i)

    def _start(self, i: int) -> None:
        box = {}

        def work():
            try:
                box["out"] = self._decode(self._chunks[i])
            except BaseException as e:  # re-raised on the consumer side
                box["err"] = e

        t = threading.Thread(target=work, daemon=True)
        t.start()
        self._pending = (i, t, box)

    def __iter__(self):
        return self

    def __next__(self) -> FrameBatch:
        i = self._i
        if i >= len(self._chunks):
            raise StopIteration
        self._i = i + 1
        if not self._prefetch:
            return self._decode(self._chunks[i])
        if self._pending is None:
            self._start(i)
        pi, t, box = self._pending
        if pi != i:
            raise RuntimeError("loader consumed out of order")
        t.join()
        self._pending = None
        if "err" in box:
            raise box["err"]
        if not self._deferred and self._i < len(self._chunks):
            self._start(self._i)
        return box["out"]


class RMSDTrajIterator:
    """Trajectory RMSD (reference: RMSDTrajRead, rmsd.rs:258), optionally
    fitting every frame onto the reference (`calc_rmsd_and_fit`,
    rmsd.rs:286).

    Each batch of frames goes to the System's device once: the group's
    refined COM of every frame (one K1 + K2 pair for the batch), QCP
    Kabsch over the batch (`ops.rmsd.rmsd_frames`) and, when fitting,
    `fit_transform` over all atoms `[B, N, 3]`; the fitted frames come
    back to the host.  Frames are then handed out one by one as
    (System, rmsd), the System holding the frame (fitted when fitting), as
    the JAX iterator does."""

    def __init__(self, reader: TrajReader, reference, group: str, fit: bool = False):
        import torch

        from ..errors import RMSDError
        from ..ops import interactive
        from ..system.rmsd import _extract, _masses

        if reader._sel is not None:
            raise RMSDError("trajectory RMSD requires full-frame reading",
                            code="PartialRead")
        self.reader = reader
        self.fit = fit
        ref_coords, ref_center, ref_idx, ref_com = _extract(reference, group)
        w = _masses(reference, group, ref_idx)
        system = reader.system
        idx = system.group_indices(group)
        if idx.shape[0] != ref_idx.shape[0]:
            raise RMSDError(
                f"group '{group}' atom count differs between reference and system",
                code="InconsistentGroup")
        dev = self.device = system.device
        put = interactive.put
        self._ref, self._ref_center = put(ref_coords, dev), put(ref_center, dev)
        self._ref_group_com = put(ref_com, dev)
        self._w = put(w, dev)
        # the fit's COM weighs by the System's own masses (JAX `:1032-1036`)
        w_fit = system.topology.mass[idx]
        self._w_fit = None if np.array_equal(w_fit, w) else put(w_fit, dev)
        contiguous = idx.shape[0] and int(idx[-1]) - int(idx[0]) + 1 == idx.shape[0]
        self._slice = slice(int(idx[0]), int(idx[-1]) + 1) if contiguous else None
        self._j = None if contiguous else torch.from_numpy(idx).to(dev)

    def _batch(self, fb: FrameBatch):
        """-> (rmsd [B], fitted frames [B, N, 3] or None) as numpy."""
        import torch

        from ..ops import center as center_ops
        from ..ops import interactive
        from ..ops import rmsd as rmsd_ops

        pos = torch.from_numpy(fb.positions).to(self.device)
        boxes = interactive.put(fb.box_lengths(), self.device)
        g = pos[:, self._slice] if self._j is None else pos.index_select(1, self._j)
        com = center_ops.center(g, boxes[:, None, :], weights=self._w)
        rot, rms = rmsd_ops.rmsd_frames(self._ref, self._ref_center, g, boxes,
                                        self._w, com=com)
        if not self.fit:
            return interactive.fetch(rms), None
        com_fit = com if self._w_fit is None else center_ops.center(
            g, boxes[:, None, :], weights=self._w_fit)
        fitted = rmsd_ops.fit_transform(pos, boxes, com_fit, rot, self._ref_group_com)
        return interactive.fetch(rms), interactive.fetch(fitted)

    def __iter__(self):
        reader = self.reader
        system = reader.system
        counter = 0
        for batch in reader._loader(env=False):
            rmss, fitted = self._batch(batch)
            for k in range(len(batch)):
                reader._update_system(batch, k)
                if fitted is not None:
                    system.box_lengths()  # the fit needs an orthogonal box
                    system.positions[:] = fitted[k]
                if reader.progress is not None:
                    reader.progress.print(counter, system.get_step(), system.get_time())
                counter += 1
                yield system, float(rmss[k])


def _with_options(reader: TrajReader, start_time=None, end_time=None,
                  step=None) -> TrajReader:
    if start_time is not None or end_time is not None:
        reader = reader.with_range(0.0 if start_time is None else start_time,
                                   float("inf") if end_time is None else end_time)
    if step is not None:
        reader = reader.with_step(step)
    return reader


def traj_iter(system, filename, fmt: str | None = None, group: str | None = None,
              start_time: float | None = None, end_time: float | None = None,
              step: int | None = None, batch_size: int = 64, indices=None,
              velocities: bool = True) -> TrajReader:
    """A batched reader over one trajectory file (`open_source`)."""
    reader = TrajReader(system, [open_source(filename, fmt)], group=group,
                        batch_size=batch_size, indices=indices,
                        velocities=velocities)
    return _with_options(reader, start_time, end_time, step)


def cat_iter(system, filenames, fmt: str | None = None, group: str | None = None,
             start_time: float | None = None, end_time: float | None = None,
             step: int | None = None, batch_size: int = 64, indices=None,
             velocities: bool = True) -> TrajReader:
    """A batched reader over files concatenated with boundary time dedup
    (reference: traj_cat.rs)."""
    if not filenames:
        raise ReadTrajError("no trajectory files provided", code="NoTrajectories")
    reader = TrajReader(system, [open_source(f, fmt) for f in filenames],
                        group=group, batch_size=batch_size, indices=indices,
                        velocities=velocities)
    return _with_options(reader, start_time, end_time, step)


def xtc_iter(system, filename, **kw) -> TrajReader:
    if FileType.from_name(filename) is not FileType.XTC:
        raise ReadTrajError(f"'{filename}' is not an xtc file", code="NotXtc")
    return traj_iter(system, filename, fmt="xtc", **kw)


def trr_iter(system, filename, **kw) -> TrajReader:
    if FileType.from_name(filename) is not FileType.TRR:
        raise ReadTrajError(f"'{filename}' is not a trr file", code="NotTrr")
    return traj_iter(system, filename, fmt="trr", **kw)


def gro_iter(system, filename, **kw) -> TrajReader:
    return traj_iter(system, filename, fmt="gro", **kw)


def tng_iter(system, filename, **kw) -> TrajReader:
    """A batched reader over one TNG file (`io/tng.py`)."""
    return traj_iter(system, filename, fmt="tng", **kw)


# =====================================================================
# Trajectory writers
# =====================================================================

class TrajWriter:
    """Base frame writer (reference: traj_write.rs:451 sealed trait): the
    group's atoms are fixed when the writer is made, and an existing file
    of that name is replaced."""

    def __init__(self, system, path, group: str = "all"):
        if not system.group_exists(group):
            raise WriteTrajError(f"group '{group}' does not exist", code="GroupNotFound")
        self.system = system
        self.path = str(path)
        self.group = group
        self.indices = system.group_indices(group)
        if os.path.exists(self.path):
            os.remove(self.path)

    def write_frame(self):
        raise NotImplementedError

    def close(self):
        pass


class XtcWriter(TrajWriter):
    def write_frame(self):
        s = self.system
        box = s.get_box()
        box33 = box.to_matrix() if box is not None else np.zeros((3, 3), np.float32)
        native.xtc_write_frame(self.path, len(self.indices), s.get_step(), s.get_time(),
                               box33.reshape(9), s.positions[self.indices],
                               float(s.get_precision()))


class TrrWriter(TrajWriter):
    def write_frame(self):
        s = self.system
        box = s.get_box()
        box33 = box.to_matrix().reshape(9) if box is not None else None
        idx = self.indices
        # the reference always writes x, v and f blocks, zeros for atoms
        # that lack the vector (trr_io.rs:483-506)
        x = np.where(s.has_position[idx, None], s.positions[idx], 0.0)
        v = np.where(s.has_velocity[idx, None], s.velocities[idx], 0.0)
        f = np.where(s.has_force[idx, None], s.forces[idx], 0.0)
        native.trr_write_frame(self.path, len(idx), s.get_step(), s.get_time(),
                               s.get_lambda(), box33, x=x, v=v, f=f)


class GroTrajWriter(TrajWriter):
    def __init__(self, system, path, group: str = "all",
                 write_velocities: bool | None = None):
        super().__init__(system, path, group)
        # None: velocities per frame iff the whole system has them
        # (reference: gro_io/trajectory.rs:545); a bool overrides
        self.write_velocities = write_velocities

    def write_frame(self):
        from .gro import write_gro_frame

        wv = (self.system.has_velocities() if self.write_velocities is None
              else self.write_velocities)
        with open(self.path, "a") as fh:
            write_gro_frame(self.system, fh, self.group, wv, is_trajectory=True)


class TngTrajWriter(TrajWriter):
    """TNG writer (`io/tng.py` `TngFrameWriter`): `codec` "gzip"
    (lossless float32) or "tng" (the XTC2 coder at `multiplier` ints/nm).
    Velocities and forces are written when every atom of the group has
    them, and the lambda of every frame."""

    def __init__(self, system, path, group: str = "all",
                 codec: str = "gzip", multiplier: float = 1000.0):
        super().__init__(system, path, group)
        from .tng import TngFrameWriter

        self._w = TngFrameWriter(self.path, len(self.indices), codec=codec,
                                 multiplier=multiplier)

    def write_frame(self):
        s = self.system
        box = s.get_box()
        box33 = box.to_matrix() if box is not None else None
        idx = self.indices
        v = s.velocities[idx] if s.has_velocity[idx].all() else None
        f = s.forces[idx] if s.has_force[idx].all() else None
        self._w.write_frame(s.positions[idx], box33, s.get_step(), s.get_time(),
                            velocities=v, forces=f, lam=s.get_lambda())

    def close(self):
        self._w.close()


class XyzTrajWriter(TrajWriter):
    """Extended-XYZ writer (the reference reads XYZ but cannot write it):
    `Lattice=` when the System has a box, `Properties=` and `Time=`;
    coordinates in Angstrom; species from the element symbols where
    guessed, else the atom names."""

    def __init__(self, system, path, group: str = "all"):
        super().__init__(system, path, group)
        topo = system.topology
        sym = topo.element_symbol.values()[self.indices]
        names = topo.atomname.values()[self.indices]
        self._species = np.where(sym == "", names, sym)

    def write_frame(self):
        s = self.system
        pos = np.asarray(s.positions[self.indices], np.float64) * 10.0
        box = s.get_box()
        comment = f"Properties=species:S:1:pos:R:3 Time={float(s.get_time()):g}"
        if box is not None:
            h = np.asarray(box.to_matrix(), np.float64) * 10.0
            lat = " ".join(f"{v:.6f}" for v in h.reshape(9))
            comment = f'Lattice="{lat}" ' + comment
        lines = [str(len(self.indices)), comment]
        lines.extend(f"{sp} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}"
                     for sp, p in zip(self._species, pos))
        with open(self.path, "a") as fh:
            fh.write("\n".join(lines) + "\n")


def make_writer(system, path, group: str = "all", fmt: str | None = None,
                **kw) -> TrajWriter:
    if fmt is None:
        fmt = FileType.from_name(path).value
    if fmt == "xtc":
        return XtcWriter(system, path, group)
    if fmt == "trr":
        return TrrWriter(system, path, group)
    if fmt == "gro":
        return GroTrajWriter(system, path, group, **kw)
    if fmt == "tng":
        return TngTrajWriter(system, path, group, **kw)
    if fmt == "xyz":
        return XyzTrajWriter(system, path, group)
    raise WriteTrajError(f"unsupported trajectory format '{fmt}'", code="UnknownFormat")
