"""ctypes binding of the native XTC and TRR codec.

The codec is the port's own copy of the JAX package's C++ codec,
`groan_rs_tpu_torch/csrc/xdrcodec.cpp` (a test holds the two
byte-identical).  It is compiled with g++ once per source hash into the port's
build directory (`groan_rs_tpu_torch/csrc/build/`), atomically (tmp +
`os.replace`: several test workers may build at once).

Bound here, with the JAX binding's argtypes
(`groan_rs_tpu/io/native.py:49-140`, `:169-260`, `:434-556`):
`xtc_scan`, `xtc_probe`, `xtc_read_frames`, `xtc_read_frames_q16`, `xtc_write_frame`,
`trr_scan`, `trr_probe`, `trr_read_frames`, `trr_write_frame` and the
hydrogen-bond candidate walk `hbond_candidates`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..errors import ReadTrajError, WriteTrajError

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_ROOT, "groan_rs_tpu_torch", "csrc")
SRC = os.path.join(CSRC, "xdrcodec.cpp")
BUILD_DIR = os.path.join(CSRC, "build")

_lock = threading.Lock()
_lib = None

_ERRORS = {
    -1: ("CouldNotOpen", "file could not be opened"),
    -2: ("NotXtc", "invalid magic number (not a valid trajectory file)"),
    -3: ("CorruptFrame", "corrupted or truncated frame"),
    -4: ("AtomsNumberMismatch", "number of atoms does not match"),
    -5: ("CouldNotRead", "i/o error while reading frame"),
    -6: ("CapacityExceeded", "frame index capacity exceeded"),
    -7: ("PrecisionTooHigh", "coordinate does not fit the requested precision"),
    -8: ("Q16Range", "quantized coordinates do not fit int16"),
    -10: ("CapacityExceeded", "output capacity exceeded"),
}


def _check(rc: int, path, write: bool = False) -> int:
    if rc >= 0:
        return rc
    code, msg = _ERRORS.get(int(rc), ("UnknownError", f"native error {rc}"))
    cls = WriteTrajError if write else ReadTrajError
    raise cls(f"{msg} ('{path}')", code=code)


def build() -> str:
    """Path of a codec library built from `SRC` (building it if needed)."""
    with open(SRC, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:12]
    so_path = os.path.join(BUILD_DIR, f"libgroanxdr-{tag}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-march=native",
           "-fno-math-errno", "-pthread", SRC, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"failed to build the native codec:\n{proc.stderr}")
    os.replace(tmp, so_path)
    return so_path


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
            f64, u8 = ctypes.c_double, ctypes.c_uint8
            P = ctypes.POINTER
            lib.gx_xtc_scan.restype = i64
            lib.gx_xtc_scan.argtypes = [ctypes.c_char_p, i64, P(i64), P(i32),
                                        P(f32), P(i32)]
            lib.gx_xtc_read.restype = i64
            lib.gx_xtc_read.argtypes = [ctypes.c_char_p, P(i64), i64, i32, i32,
                                        P(f32), P(f32), P(i32), P(f32), P(f32),
                                        i32]
            lib.gx_xtc_read_q16.restype = i64
            lib.gx_xtc_read_q16.argtypes = [ctypes.c_char_p, P(i64), i64, i32,
                                            i32, P(ctypes.c_int16), P(f32),
                                            P(i32), P(f32), P(f32), i32]
            lib.gx_xtc_write_frame.restype = i64
            lib.gx_xtc_write_frame.argtypes = [ctypes.c_char_p, i32, i32, f32,
                                               P(f32), P(f32), f32]
            lib.gx_trr_scan.restype = i64
            lib.gx_trr_scan.argtypes = [ctypes.c_char_p, i64, P(i64), P(i32),
                                        P(f64), P(f64), P(u8), P(i32)]
            lib.gx_trr_read.restype = i64
            lib.gx_trr_read.argtypes = [ctypes.c_char_p, P(i64), i64, i32, i32,
                                        P(f32), P(f32), P(f32), P(f32), P(i32),
                                        P(f64), P(f64), P(u8), i32]
            lib.gx_xtc_probe.restype = i64
            lib.gx_xtc_probe.argtypes = [ctypes.c_char_p, P(i32), P(i32)]
            lib.gx_trr_probe.restype = i64
            lib.gx_trr_probe.argtypes = [ctypes.c_char_p, P(i32)]
            lib.gx_trr_write_frame.restype = i64
            lib.gx_trr_write_frame.argtypes = [ctypes.c_char_p, i32, i32, f64,
                                               f64, P(f32), P(f32), P(f32),
                                               P(f32)]
            lib.gx_hbond_candidates.restype = i64
            lib.gx_hbond_candidates.argtypes = [P(f32), P(f32), P(i32), i32,
                                                P(i32), i32, f32, P(i32),
                                                P(i32), i64]
            _lib = lib
    return _lib


def _p(arr, ctype):
    """A ctypes pointer to `arr`'s data (NULL for None)."""
    return None if arr is None else arr.ctypes.data_as(ctypes.POINTER(ctype))


def _steps_u32(steps):
    """XTC and TRR store the step as 32 raw bits, read unsigned
    (molly_xtc.rs)."""
    return steps.astype(np.uint32).astype(np.int64)


def _step_bits(step: int) -> int:
    step = int(step) & 0xFFFFFFFF
    return step - 0x100000000 if step >= 0x80000000 else step


def _index_capacity(path, min_frame_bytes: int) -> int:
    try:
        fsize = os.path.getsize(path)
    except OSError:
        raise ReadTrajError(f"file '{path}' was not found",
                            code="FileNotFound") from None
    return max(16, fsize // min_frame_bytes + 4)


def xtc_scan(path):
    """Frame index -> (offsets i64[F], steps i64[F], times f32[F], natoms)."""
    lib = get_lib()
    cap = _index_capacity(path, 56)
    offsets = np.empty(cap, np.int64)
    steps = np.empty(cap, np.int32)
    times = np.empty(cap, np.float32)
    natoms = ctypes.c_int32(0)
    n = _check(lib.gx_xtc_scan(str(path).encode(), cap, _p(offsets, ctypes.c_int64),
                               _p(steps, ctypes.c_int32),
                               _p(times, ctypes.c_float), ctypes.byref(natoms)),
               path)
    return (offsets[:n].copy(), _steps_u32(steps[:n]), times[:n].copy(),
            int(natoms.value))


def xtc_probe(path):
    """(atom count, magic number) of an XTC file's first frame header."""
    natoms = ctypes.c_int32(0)
    magic = ctypes.c_int32(0)
    _check(get_lib().gx_xtc_probe(str(path).encode(), ctypes.byref(natoms),
                                  ctypes.byref(magic)), path)
    return int(natoms.value), int(magic.value)


def n_default_threads() -> int:
    """Decoder threads: `GROAN_DECODE_THREADS` when set, else one per CPU
    core (JAX `io/native.py:144-148`)."""
    env = os.environ.get("GROAN_DECODE_THREADS")
    if env:
        return max(1, int(env))
    return max(1, os.cpu_count() or 1)


def _read(fn, dtype, ctype, path, offsets, natoms, stop_after):
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    nf = offsets.shape[0]
    stop = int(stop_after) if stop_after is not None else int(natoms)
    coords = np.empty((nf, stop, 3), dtype)
    boxes = np.empty((nf, 9), np.float32)
    steps = np.empty(nf, np.int32)
    times = np.empty(nf, np.float32)
    precisions = np.empty(nf, np.float32)
    rc = fn(str(path).encode(), _p(offsets, ctypes.c_int64), nf, natoms, stop,
            _p(coords, ctype), _p(boxes, ctypes.c_float),
            _p(steps, ctypes.c_int32), _p(times, ctypes.c_float),
            _p(precisions, ctypes.c_float), n_default_threads())
    _check(rc, path)
    return coords, boxes, _steps_u32(steps), times, precisions


def xtc_read_frames(path, offsets, natoms: int, stop_after: int | None = None):
    """Decode frames (`n_default_threads()` decoder threads) -> (coords f32
    [F, stop_after, 3], boxes [F, 9] (row-major 3x3), steps, times,
    precisions)."""
    return _read(get_lib().gx_xtc_read, np.float32, ctypes.c_float, path,
                 offsets, natoms, stop_after)


def xtc_read_frames_q16(path, offsets, natoms: int, stop_after: int | None = None):
    """Decode frames into raw quantized int16 coordinates; dequantize with
    `q.float() * (1 / precision)` for floats bit-identical to
    `xtc_read_frames`.  Raises ReadTrajError(code='Q16Range') when the
    file's integers exceed int16."""
    return _read(get_lib().gx_xtc_read_q16, np.int16, ctypes.c_int16, path,
                 offsets, natoms, stop_after)


def xtc_write_frame(path, natoms: int, step: int, time: float, box9, coords,
                    precision: float):
    """Append one frame (box9: row-major 3x3) to an XTC file."""
    lib = get_lib()
    box9 = np.ascontiguousarray(box9, np.float32).reshape(9)
    coords = np.ascontiguousarray(coords, np.float32).reshape(-1)
    rc = lib.gx_xtc_write_frame(str(path).encode(), natoms, _step_bits(step),
                                float(time), _p(box9, ctypes.c_float),
                                _p(coords, ctypes.c_float), float(precision))
    _check(rc, path, write=True)


# ---------------------------------------------------------------- TRR


def trr_scan(path):
    """Frame index -> (offsets i64[F], steps i64[F], times f64[F], lambdas
    f64[F], flags u8[F], natoms); flag bits: 1 = x, 2 = v, 4 = f,
    8 = double precision."""
    lib = get_lib()
    cap = _index_capacity(path, 76)
    offsets = np.empty(cap, np.int64)
    steps = np.empty(cap, np.int32)
    times = np.empty(cap, np.float64)
    lambdas = np.empty(cap, np.float64)
    flags = np.empty(cap, np.uint8)
    natoms = ctypes.c_int32(0)
    n = _check(lib.gx_trr_scan(str(path).encode(), cap, _p(offsets, ctypes.c_int64),
                               _p(steps, ctypes.c_int32), _p(times, ctypes.c_double),
                               _p(lambdas, ctypes.c_double), _p(flags, ctypes.c_uint8),
                               ctypes.byref(natoms)),
               path)
    return (offsets[:n].copy(), _steps_u32(steps[:n]), times[:n].copy(),
            lambdas[:n].copy(), flags[:n].copy(), int(natoms.value))


def trr_probe(path) -> int:
    """The atom count of a TRR file's first frame."""
    natoms = ctypes.c_int32(0)
    _check(get_lib().gx_trr_probe(str(path).encode(), ctypes.byref(natoms)), path)
    return int(natoms.value)


def trr_read_frames(path, offsets, natoms: int, want_x: bool = True,
                    want_v: bool = True, want_f: bool = False,
                    stop_after: int | None = None):
    """Read frames -> (x, v, f (each f32 [F, stop_after, 3], zeros where a
    frame lacks the block, or None when not wanted), boxes [F, 9]
    (row-major 3x3), steps, times f64, lambdas f64, flags u8).  TRR
    blocks are uncompressed: `stop_after` reads only the first atoms'
    bytes of each block."""
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    nf = offsets.shape[0]
    stop = int(stop_after) if stop_after is not None else int(natoms)

    def block(want):
        return np.zeros((nf, stop, 3), np.float32) if want else None

    x, v, f = block(want_x), block(want_v), block(want_f)
    boxes = np.empty((nf, 9), np.float32)
    steps = np.empty(nf, np.int32)
    times = np.empty(nf, np.float64)
    lambdas = np.empty(nf, np.float64)
    flags = np.empty(nf, np.uint8)
    fl = ctypes.c_float
    rc = get_lib().gx_trr_read(
        str(path).encode(), _p(offsets, ctypes.c_int64), nf, natoms, stop,
        _p(x, fl), _p(v, fl), _p(f, fl), _p(boxes, fl), _p(steps, ctypes.c_int32),
        _p(times, ctypes.c_double), _p(lambdas, ctypes.c_double),
        _p(flags, ctypes.c_uint8), n_default_threads())
    _check(rc, path)
    return x, v, f, boxes, _steps_u32(steps), times, lambdas, flags


def hbond_candidates(positions, box3, acceptors, donors, max_distance,
                     cap: int | None = None):
    """Cell-pruned (donor, acceptor) candidate pair RANKS of one frame, in
    the reference's order (`gx_hbond_candidates`: donors in chain order,
    per donor its <= 27 neighbour cells in (x, y, z) offset order, within
    a cell ascending atom index) -> (d_rank, a_rank) int64."""
    lib = get_lib()
    pos = np.ascontiguousarray(positions, np.float32)
    box = np.ascontiguousarray(box3, np.float32).reshape(3)
    acc = np.ascontiguousarray(acceptors, np.int32)
    don = np.ascontiguousarray(donors, np.int32)
    n_guess = int(cap) if cap else max(1024, 64 * don.shape[0])
    i32 = ctypes.c_int32
    while True:
        d_out = np.empty(n_guess, np.int32)
        a_out = np.empty(n_guess, np.int32)
        rc = lib.gx_hbond_candidates(
            _p(pos, ctypes.c_float), _p(box, ctypes.c_float), _p(acc, i32),
            acc.shape[0], _p(don, i32), don.shape[0], float(max_distance),
            _p(d_out, i32), _p(a_out, i32), n_guess)
        if rc == -10:  # capacity exceeded: double and retry
            n_guess *= 2
            continue
        n = _check(rc, "<hbond candidates>")
        return d_out[:n].astype(np.int64), a_out[:n].astype(np.int64)


def trr_write_frame(path, natoms: int, step: int, time: float, lam: float, box9,
                    x=None, v=None, f=None):
    """Append one single-precision frame (box9: row-major 3x3 or None;
    each of x, v, f `[natoms, 3]` or None) to a TRR file."""
    def prep(a, n):
        return None if a is None else np.ascontiguousarray(a, np.float32).reshape(n)

    fl = ctypes.c_float
    rc = get_lib().gx_trr_write_frame(
        str(path).encode(), natoms, _step_bits(step), float(time), float(lam),
        _p(prep(box9, 9), fl), _p(prep(x, -1), fl), _p(prep(v, -1), fl),
        _p(prep(f, -1), fl))
    _check(rc, path, write=True)
