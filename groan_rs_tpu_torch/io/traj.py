"""Batched trajectory reading for the device pipeline.

Port of `groan_rs_tpu/io/traj.py` (`FrameBatch` :45-107,
`XtcSource` :168-220, `TrrSource` :222-257, `TrajReader` :418-690,
`cat_iter` :1101, the loader :894-958):

- A source (`XtcSource`, `TrrSource`) scans its file's frame index once
  (offsets, steps, times).  GRO and TNG trajectories are not ported yet.
- `TrajReader` holds one frame table over one file or several
  concatenated ones: equal times are dropped only at a file boundary
  (duplicates inside one file stay, traj_cat.rs:229-260).  `with_range`
  keeps the frames within `TIME_PRECISION` of a time range and
  `with_step` every n-th frame; the two commute, as the reference's
  adapters do (traj_read.rs:301-514).
- `batches(wire=...)` yields `[B, K, 3]` numpy `FrameBatch`es decoded in
  bulk by the native codec on a background thread, one batch ahead of
  the consumer.  A batch that straddles two files is read as f32 per
  part and concatenated; a TRR batch is always f32 and carries the
  velocities (`FrameBatch.velocities`).
- A selection (`group=` or `indices=`) decodes only up to its last atom
  (`stop_after`: the partial-frame early stop of molly_xtc.rs:58-63, a
  byte-range read for TRR) and is then gathered — as a slice when
  contiguous, a no-op when it is the decoded prefix.
- Wires: "f32" (float32 positions) and "q16" (raw quantized int16, 6 B per
  atom; `pos = float32(q) * (1 / precision)` on the device is bit-identical
  to the float decode).  "auto" resolves to "q16", with the JAX reader's
  fallback to f32 when a file's integers do not fit int16.  The delta wires
  are not ported (ROADMAP.md).
- Iterating a `TrajReader` yields the System once per frame, holding
  that frame's positions, box, step and time (JAX `io/traj.py:822-889`);
  `read_frames` reads frames by number as one f32 batch (`:588`).
- `print_progress` ticks a `ProgressPrinter` as batches are handed out:
  every frame counts (printed every `print_freq` frames), then COMPLETED,
  or FAILED when reading fails.  (The JAX runner attaches the printer but
  its batch path prints nothing.)
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from ..errors import ReadTrajError
from ..files import FileType
from ..progress import ProgressPrinter, ProgressStatus
from . import native

__all__ = ["TIME_PRECISION", "FrameBatch", "XtcSource", "TrrSource", "open_source",
           "TrajReader", "traj_iter", "cat_iter"]

TIME_PRECISION = 0.001  # reference: molly_xtc.rs:30

# (row, column) of each gro-order box component in the row-major matrix
_GRO_ORDER = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 0), (1, 2), (2, 0),
              (2, 1))


@dataclass
class FrameBatch:
    """A decoded batch of frames (host numpy)."""

    positions: np.ndarray  # [B, K, 3] float32 ("f32") or int16 ("q16")
    boxes9: np.ndarray  # [B, 9] gro-order box components
    steps: np.ndarray  # [B] int64
    times: np.ndarray  # [B] float32
    frame_numbers: np.ndarray  # [B] frame indices in the iteration
    precisions: np.ndarray | None = None  # [B] float32
    velocities: np.ndarray | None = None  # [B, K, 3] float32 (TRR)
    atom_indices: np.ndarray | None = None  # selection indices if partial
    wire: str = "f32"

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


def _magic_error(path, kind):
    return ReadTrajError(
        f"could not read magic number from '{path}' (empty or not an {kind} "
        "file)", code="CouldNotReadMagic")


class XtcSource:
    """An XTC file with its scanned frame index."""

    kind = "xtc"

    def __init__(self, path):
        self.path = str(path)
        offsets, steps, times, natoms = native.xtc_scan(self.path)
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
        read = native.xtc_read_frames_q16 if wire == "q16" else native.xtc_read_frames
        coords, boxes, steps, times, precisions = read(
            self.path, self.offsets[frame_ids], self.natoms, stop_after=stop_after)
        return FrameBatch(
            positions=coords, boxes9=_xtc_box_to_gro9(boxes),
            steps=steps.astype(np.int64), times=times,
            frame_numbers=np.asarray(frame_ids, np.int64),
            precisions=precisions, wire=wire)


class TrrSource:
    """A TRR file with its scanned frame index.  Its batches are f32 and
    carry the velocities (zeros in a frame without a velocity block, as
    in the JAX package); forces are not read."""

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
        x, v, _, boxes, steps, times, _, _ = native.trr_read_frames(
            self.path, self.offsets[frame_ids], self.natoms, want_v=velocities,
            stop_after=stop_after)
        return FrameBatch(
            positions=x, velocities=v, boxes9=_xtc_box_to_gro9(boxes),
            steps=steps.astype(np.int64), times=times.astype(np.float32),
            frame_numbers=np.asarray(frame_ids, np.int64))


def open_source(path, fmt: str | None = None):
    """The frame source of an XTC or TRR file (by extension unless `fmt`
    names the format)."""
    if fmt is None:
        fmt = FileType.from_name(path).value
    if fmt == "xtc":
        return XtcSource(path)
    if fmt == "trr":
        return TrrSource(path)
    raise ReadTrajError(f"unsupported trajectory format '{fmt}' ('{path}'; XTC "
                        "and TRR are ported, other formats are not yet)",
                        code="UnknownFormat")


def _concat(parts) -> FrameBatch:
    if len(parts) == 1:
        return parts[0]

    def cat(name):
        arrs = [getattr(p, name) for p in parts]
        return None if any(a is None for a in arrs) else np.concatenate(arrs)

    return FrameBatch(positions=cat("positions"), boxes9=cat("boxes9"),
                      steps=cat("steps"), times=cat("times"),
                      frame_numbers=cat("frame_numbers"),
                      precisions=cat("precisions"), velocities=cat("velocities"))


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

    # ------------------------------------------------------------- frames
    def __iter__(self):
        """Per-frame iteration: each frame written into the System, which
        is yielded (JAX `io/traj.py:822-841`)."""
        p = self.progress
        counter = 0
        try:
            for batch in self.batches():
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
        XtcFrameData::update_system, molly_xtc.rs:292-306): positions (of
        the selection only, when there is one), velocities where the batch
        carries them, box, step and time."""
        from ..core.simbox import SimBox

        s = self.system
        sel = batch.atom_indices
        at = slice(None) if sel is None else sel
        s.positions[at] = batch.positions[k]
        s.has_position[at] = True
        if batch.velocities is not None:
            s.velocities[at] = batch.velocities[k]
        s.has_velocity[at] = batch.velocities is not None
        b9 = batch.boxes9[k]
        s.set_box(SimBox.from_gro_line(b9) if np.any(b9 != 0.0) else None)
        s.set_step(int(batch.steps[k]))
        s.set_time(float(batch.times[k]))

    # ------------------------------------------------------------- batches
    def batches(self, wire: str = "f32"):
        """Iterate FrameBatches: bulk native decode, one batch decoded ahead
        on a background thread."""
        if wire not in ("f32", "q16", "auto"):
            raise ReadTrajError(f"unsupported wire format '{wire}' "
                                "(f32, q16 or auto)", code="InvalidWire")
        bs = self.batch_size
        sel = self.selected_frames()
        chunks = [sel[i:i + bs] for i in range(0, len(sel), bs)]
        state = {"q16_ok": wire in ("q16", "auto")}

        def load(chunk) -> FrameBatch:
            srcs = self._src[chunk]
            uniq = np.unique(srcs)
            parts = []
            for si in uniq:
                part = self._read_part(self.sources[int(si)],
                                       self._local[chunk[srcs == si]],
                                       state if len(uniq) == 1 else None)
                part.frame_numbers = chunk[srcs == si]
                parts.append(part)
            out = _concat(parts)
            if self._sel is not None:
                self._gather_selection(out)
            return out

        loader = _PrefetchLoader(load, chunks)
        return loader if self.progress is None else self._ticked(loader)

    def _read_part(self, src, ids, state) -> FrameBatch:
        """One source's frames: q16 where the state allows it (XTC only,
        with the fallback to f32 for the rest of the pass on Q16Range),
        f32 otherwise."""
        kw = {"stop_after": self._stop_after, "velocities": self.velocities}
        if state is not None and state["q16_ok"] and src.kind == "xtc":
            try:
                return src.read_batch(ids, wire="q16", **kw)
            except ReadTrajError as e:
                if e.code != "Q16Range":
                    raise
                state["q16_ok"] = False
        return src.read_batch(ids, wire="f32", **kw)

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
    decode in order."""

    def __init__(self, load, chunks):
        self._load = load
        self._chunks = list(chunks)
        self._i = 0
        self._pending = None  # (index, thread, result box)
        if self._chunks:
            self._start(0)

    def _start(self, i: int) -> None:
        box = {}

        def work():
            try:
                box["out"] = self._load(self._chunks[i])
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
        pi, t, box = self._pending
        if pi != i:
            raise RuntimeError("loader consumed out of order")
        t.join()
        self._pending = None
        if "err" in box:
            raise box["err"]
        if self._i < len(self._chunks):
            self._start(self._i)
        return box["out"]


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
    """A batched reader over one XTC or TRR file."""
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
