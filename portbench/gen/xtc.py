"""The benchmark's frozen XTC writer: `xtcwriter.cpp`, built by the host
C++ compiler into `portbench/build/` (a fixed directory inside the
checkout, so only the first run in a checkout compiles it), called
through ctypes.

Frames compress independently, so `write_xtc` compresses them on a pool
of host threads (ctypes releases the interpreter lock during the call)
and writes them in order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "xtcwriter.cpp")
BUILD_DIR = os.path.join(os.path.dirname(HERE), "build")

_lib = None


def library():
    """The writer's shared library, compiled on first use (keyed by the
    source's hash; written under a temporary name and renamed)."""
    global _lib
    if _lib is not None:
        return _lib
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    so = os.path.join(BUILD_DIR, f"libpbxtc-{tag}.so")
    if not os.path.exists(so):
        cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no host C++ compiler (g++ or c++) to build the XTC writer")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.part{os.getpid()}"
        subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", SOURCE, "-o", tmp],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.pb_xtc_frame.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                                 ctypes.c_float, ctypes.c_void_p, ctypes.c_float,
                                 ctypes.c_void_p, ctypes.c_int64]
    lib.pb_xtc_frame.restype = ctypes.c_int64
    _lib = lib
    return lib


def encode_frame(ints, step: int, time: float, box9, precision: float) -> bytes:
    """One XTC frame of quantised coordinates `ints` [N, 3] int32."""
    ints = np.ascontiguousarray(ints, np.int32)
    box9 = np.ascontiguousarray(box9, np.float32).reshape(9)
    n = ints.shape[0]
    out = np.empty(n * 16 + 256, np.uint8)
    size = library().pb_xtc_frame(ints.ctypes.data, n, int(step), float(time),
                                  box9.ctypes.data, float(precision),
                                  out.ctypes.data, out.nbytes)
    if size < 0:
        raise RuntimeError(f"XTC frame encode failed ({size})")
    return out[:size].tobytes()


def write_xtc(path, frames, box9, precision: float, dt_ps: float = 10.0,
              threads: int = 1) -> int:
    """Write the XTC `path` from `frames`, an iterable of int32 [N, 3]
    arrays in frame order; frame f gets step 1000 f and time f * dt_ps.
    -> bytes written."""
    library()
    box9 = np.asarray(box9, np.float32).reshape(9)
    total = 0

    def job(item):
        f, ints = item
        return encode_frame(ints, f * 1000, f * dt_ps, box9, precision)

    threads = max(1, threads)
    pending = []
    with open(path, "wb") as fh, ThreadPoolExecutor(max_workers=threads) as pool:
        # at most 2 x threads frames in flight: the frames come from a
        # generator and are ~12 MB each at 1M atoms
        for item in enumerate(frames):
            pending.append(pool.submit(job, item))
            if len(pending) >= 2 * threads:
                blob = pending.pop(0).result()
                fh.write(blob)
                total += len(blob)
        for fut in pending:
            blob = fut.result()
            fh.write(blob)
            total += len(blob)
    return total
