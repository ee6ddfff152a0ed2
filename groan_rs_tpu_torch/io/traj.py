"""Batched XTC reading for the device pipeline.

Port of the batch path of `groan_rs_tpu/io/traj.py` (`FrameBatch` :45-107,
`XtcSource` :168-220, `TrajReader.batches` :418-690, the loader :894-958):

- `XtcSource` scans the file's frame index once (offsets, steps, times).
- `TrajReader.batches(wire=...)` yields `[B, K, 3]` numpy `FrameBatch`es
  decoded in bulk by the native codec on a background thread, one batch
  ahead of the consumer.
- A selection decodes only up to its last atom (`stop_after`, the
  partial-frame early stop of molly_xtc.rs:58-63) and is then gathered —
  as a slice when contiguous, a no-op when it is the decoded prefix.
- Wires: "f32" (float32 positions) and "q16" (raw quantized int16, 6 B per
  atom; `pos = float32(q) * (1 / precision)` on the device is bit-identical
  to the float decode).  "auto" resolves to "q16", with the JAX reader's
  fallback to f32 when a file's integers do not fit int16.  The delta wires
  are not ported (ROADMAP.md).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from ..errors import ReadTrajError
from . import native

__all__ = ["FrameBatch", "XtcSource", "TrajReader", "traj_iter"]


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
    """[F, 9] row-major 3x3 (XTC storage) -> gro-order 9-vector."""
    b = box33.reshape(-1, 3, 3)
    return np.stack([b[:, i, j] for i, j in _GRO_ORDER], axis=1).astype(np.float32)


class XtcSource:
    """An XTC file with its scanned frame index."""

    def __init__(self, path):
        self.path = str(path)
        offsets, steps, times, natoms = native.xtc_scan(self.path)
        if natoms <= 0:
            raise ReadTrajError(
                f"could not read magic number from '{self.path}' (empty or "
                "not an xtc file)", code="CouldNotReadMagic")
        self.offsets = offsets
        self.steps = steps.astype(np.int64)
        self.times = times
        self.natoms = natoms

    def n_frames(self) -> int:
        return self.times.shape[0]

    def read_batch(self, frame_ids, stop_after=None, wire: str = "f32") -> FrameBatch:
        read = native.xtc_read_frames_q16 if wire == "q16" else native.xtc_read_frames
        coords, boxes, steps, times, precisions = read(
            self.path, self.offsets[frame_ids], self.natoms, stop_after=stop_after)
        return FrameBatch(
            positions=coords, boxes9=_xtc_box_to_gro9(boxes),
            steps=steps.astype(np.int64), times=times,
            frame_numbers=np.asarray(frame_ids, np.int64),
            precisions=precisions, wire=wire)


class TrajReader:
    """Batched iteration over one XTC trajectory of `system`, optionally
    restricted to an atom selection (`indices`)."""

    def __init__(self, system, source: XtcSource, batch_size: int = 64,
                 indices=None):
        self.source = source
        self.batch_size = batch_size
        natoms = source.natoms
        if natoms != system.get_n_atoms():
            raise ReadTrajError(
                f"trajectory '{source.path}' has {natoms} atoms but system "
                f"has {system.get_n_atoms()}", code="AtomsNumberMismatch")
        self._sel = None
        self._stop_after = None
        if indices is not None:
            sel = np.unique(np.asarray(indices, np.int64))
            if len(sel) and (sel[0] < 0 or sel[-1] >= natoms):
                raise ReadTrajError(
                    f"selection indices out of range [0, {natoms})",
                    code="InvalidSelection")
            self._sel = sel
            self._stop_after = int(sel[-1]) + 1 if len(sel) else 0

    @property
    def times(self) -> np.ndarray:
        return self.source.times

    @property
    def steps(self) -> np.ndarray:
        return self.source.steps

    def batches(self, wire: str = "f32"):
        """Iterate FrameBatches: bulk native decode, one batch decoded ahead
        on a background thread."""
        if wire not in ("f32", "q16", "auto"):
            raise ReadTrajError(f"unsupported wire format '{wire}' "
                                "(f32, q16 or auto)", code="InvalidWire")
        bs = self.batch_size
        ids = np.arange(self.source.n_frames())
        chunks = [ids[i:i + bs] for i in range(0, len(ids), bs)]
        state = {"q16_ok": wire in ("q16", "auto")}

        def load(chunk) -> FrameBatch:
            out = None
            if state["q16_ok"]:
                try:
                    out = self.source.read_batch(chunk, self._stop_after, "q16")
                except ReadTrajError as e:
                    if e.code != "Q16Range":
                        raise
                    state["q16_ok"] = False  # the rest of the file ships f32
            if out is None:
                out = self.source.read_batch(chunk, self._stop_after, "f32")
            if self._sel is not None:
                self._gather_selection(out)
            return out

        return _PrefetchLoader(load, chunks)

    def _gather_selection(self, out: FrameBatch) -> None:
        """Compact a decoded batch to the selection: a contiguous prefix
        that the decode already stopped at is a relabel, another contiguous
        range a slice, anything else a gather."""
        sel = self._sel
        n = len(sel)
        contig = n > 0 and int(sel[-1]) - int(sel[0]) == n - 1
        if contig and int(sel[0]) == 0 and out.positions.shape[1] == n:
            pass
        elif contig:
            out.positions = out.positions[:, int(sel[0]):int(sel[0]) + n, :]
        else:
            out.positions = out.positions[:, sel, :]
        out.atom_indices = sel


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


def traj_iter(system, filename, batch_size: int = 64, indices=None) -> TrajReader:
    """A batched reader over one XTC file (`.xtc` only in this slice)."""
    if not str(filename).lower().endswith(".xtc"):
        raise ReadTrajError(f"'{filename}' is not an xtc file (other formats "
                            "are not ported yet)", code="UnknownFormat")
    return TrajReader(system, XtcSource(filename), batch_size=batch_size,
                      indices=indices)
