"""The Hopper kernels of the port, their plain PyTorch twins and wrappers.

Counterpart of `groan_rs_tpu/ops/pallas_kernels.py`.  Each of its three
Pallas kernels has a hand-written CUDA C++ kernel for `sm_90a` under
`groan_rs_tpu_torch/csrc/`:

| TPU kernel (pallas_kernels.py)  | CUDA source             | wrapper               |
| ------------------------------- | ----------------------- | --------------------- |
| K1 `_center_tile_kernel` :159   | `csrc/bai_breen.cu`     | `bai_breen_estimate`  |
| K2 `_refine_tile_kernel` :250   | `csrc/bai_breen.cu`     | `bai_breen_refine`    |
| K3 `_pair_tile_kernel` :27      | `csrc/pair_reduce.cu`   | `pair_reduce`         |

Every wrapper checks device, dtype, shape and strides, then runs the
kernel's plain twin (`*_plain`, the same arithmetic in PyTorch) for CPU
tensors and launches the kernel for CUDA tensors.  There is no fallback:
a CUDA tensor whose kernel fails to build or launch raises.

The kernels are built at first use, not at import: one `nvcc` call
compiles every `csrc/*.cu` into a shared library with a plain C interface
(`csrc/build/libgroan_kernels-<hash>.so`, keyed by the sources and flags)
that ctypes loads.  Launches go to `torch.cuda.current_stream()`.

`launch_counts` counts kernel launches per wrapper (a plain integer each,
incremented only where the kernel is launched, never on the CPU path), so
a run can show that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading

import torch

__all__ = [
    "launch_counts", "reset_launch_counts", "build", "build_log",
    "bai_breen_estimate", "bai_breen_refine", "bai_breen_center",
    "pair_reduce", "bai_breen_estimate_plain", "bai_breen_refine_plain",
    "bai_breen_center_plain", "pair_reduce_plain",
]

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("bai_breen.cu", "pair_reduce.cu")
# no --use_fast_math (sincosf accuracy over 0..2 pi); --fmad=false keeps
# every product and sum rounding like the plain twins (exact K3 counts)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

launch_counts = {"bai_breen_estimate": 0, "bai_breen_refine": 0,
                 "pair_reduce": 0}

_TWO_PI = 6.283185307179586
_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the last build (register/smem report)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------- build


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or put the CUDA toolkit on PATH); the "
        "port's CUDA kernels cannot be built")


def build() -> str:
    """Compile `csrc/*.cu` once per source hash; returns the library path."""
    global build_log
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(fh.read())
    so_path = os.path.join(BUILD_DIR, f"libgroan_kernels-{h.hexdigest()[:12]}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, so_path)
    return so_path


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ll, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_int, ctypes.c_float)
            lib.gk_bb_atoms_per_block.restype = i32
            lib.gk_bb_atoms_per_block.argtypes = []
            lib.gk_bb_refine_tile.restype = i32
            lib.gk_bb_refine_tile.argtypes = []
            lib.gk_bb_launches.restype = ctypes.c_ulonglong
            lib.gk_bb_launches.argtypes = []
            lib.gk_bb_estimate.restype = i32
            lib.gk_bb_estimate.argtypes = [vp, ll, i32, vp, vp, vp, vp, vp,
                                           i32, vp]
            lib.gk_bb_refine.restype = i32
            lib.gk_bb_refine.argtypes = [vp, ll, i32, vp, vp, vp, vp, vp, vp,
                                         i32, vp]
            lib.gk_pair_reduce.restype = i32
            lib.gk_pair_reduce.argtypes = [vp, ll, i32, vp, ll, i32, vp, f32,
                                           vp, vp, i32, vp]
            _lib = lib
    return _lib


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch "
                           f"(cudaError {rc})")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t) -> ctypes.c_void_p | None:
    return None if t is None else ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------- argument checks


def _on_kernel(*tensors) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the twin); raises for any other device or a device mix."""
    devs = {t.device for t in tensors if isinstance(t, torch.Tensor)}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device '{dev}' (cpu or cuda)")
    if not torch.cuda.is_available():
        raise RuntimeError(f"tensor on '{dev}' but CUDA is not available")
    return True


def _frames(pos: torch.Tensor, name: str = "positions") -> torch.Tensor:
    """[N, 3] or [B, N, 3] float32 -> [B, N, 3] with atom rows of 3
    contiguous floats (any frame stride: slice views pass without a copy)."""
    if pos.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {pos.dtype}")
    if pos.dim() == 2:
        pos = pos.unsqueeze(0)
    if pos.dim() != 3 or pos.shape[-1] != 3:
        raise ValueError(f"{name} must be [N, 3] or [B, N, 3], got {tuple(pos.shape)}")
    if pos.shape[1] > 1 and pos.stride(1) != 3 or pos.stride(2) != 1:
        pos = pos.contiguous()
    if pos.shape[1] * 3 >= 2**31:
        raise ValueError(f"{name}: too many atoms for one launch")
    return pos


def _boxes(box, n_frames: int, like: torch.Tensor) -> torch.Tensor:
    """Broadcastable orthorhombic box lengths -> contiguous [B, 3] float32."""
    box = torch.as_tensor(box, dtype=torch.float32, device=like.device)
    if box.dim() == 3 and box.shape[1] == 1:
        box = box[:, 0, :]
    if box.dim() == 1:
        box = box.unsqueeze(0)
    if box.dim() != 2 or box.shape[-1] != 3 or box.shape[0] not in (1, n_frames):
        raise ValueError(f"box must broadcast to [{n_frames}, 3], got {tuple(box.shape)}")
    return box.expand(n_frames, 3).contiguous()


def _weights(w, n: int, like: torch.Tensor) -> torch.Tensor | None:
    if w is None:
        return None
    w = torch.as_tensor(w, device=like.device)
    if w.dtype != torch.float32:
        w = w.to(torch.float32)
    if w.shape != (n,):
        raise ValueError(f"weights must be [{n}], got {tuple(w.shape)}")
    return w.contiguous()


def _squeeze_like(out: torch.Tensor, pos_in: torch.Tensor) -> torch.Tensor:
    return out[0] if pos_in.dim() == 2 else out


# ---------------------------------------------------------------- K1: estimate


_ticket_bufs: dict = {}  # device -> uint32 tickets of K1's and K2's finish


def _tickets(device, n_frames: int) -> torch.Tensor:
    """K1's and K2's per-frame tickets on `device`, at least `n_frames`
    long.

    Every launch of either kernel leaves them all 0 (the block that
    finishes a frame resets its ticket), so the buffer is zeroed once, when
    it is made or grown.  One buffer per device, shared by K1 and K2:
    launches that share it must not overlap, which holds because every
    kernel of the port goes to the current stream in turn, and a launch
    that finds every ticket at 0 cannot tell which kernel ran before it."""
    buf = _ticket_bufs.get(device)
    if buf is None or buf.numel() < n_frames:
        buf = torch.zeros(max(n_frames, 64), dtype=torch.int32, device=device)
        _ticket_bufs[device] = buf
    return buf


def bai_breen_estimate_plain(pos, weights, boxes):
    """Twin of K1 over [B, N, 3] frames, [N] weights (None = ones) and
    [B, 3] boxes -> [B, 3] circular-mean estimates (NaN when empty)."""
    L = boxes[:, None, :]
    two_pi = torch.tensor(_TWO_PI, dtype=torch.float32, device=pos.device)
    xw = pos - L * torch.floor(pos / L)
    theta = xw * (two_pi / L)
    if weights is None:
        xi = torch.cos(theta).sum(1)
        zeta = torch.sin(theta).sum(1)
        wsum = torch.full((pos.shape[0], 1), float(pos.shape[1]),
                          device=pos.device)
    else:
        w = weights[None, :, None]
        xi = (w * torch.cos(theta)).sum(1)
        zeta = (w * torch.sin(theta)).sum(1)
        wsum = weights.sum().reshape(1, 1).expand(pos.shape[0], 1)
    theta_c = torch.atan2(-zeta, -xi) + math.pi
    est = theta_c * (boxes / two_pi)
    return torch.where(wsum == 0, torch.nan, est)


def bai_breen_estimate(positions, weights, box):
    """K1: Bai-Breen circular-mean estimate per frame.

    positions [N, 3] or [B, N, 3] float32; weights [N] (0 = excluded) or
    None; box broadcastable to [B, 3] -> [3] or [B, 3]."""
    kernel = _on_kernel(positions, weights, box)
    pos = _frames(positions)
    b, n = pos.shape[0], pos.shape[1]
    boxes = _boxes(box, b, pos)
    w = _weights(weights, n, pos)
    if not kernel:
        return _squeeze_like(bai_breen_estimate_plain(pos, w, boxes), positions)
    lib = _load()
    nblk = max(1, -(-n // lib.gk_bb_atoms_per_block()))
    partials = torch.empty((b, nblk, 7), dtype=torch.float32, device=pos.device)
    est = torch.empty((b, 3), dtype=torch.float32, device=pos.device)
    with torch.cuda.device(pos.device):
        rc = lib.gk_bb_estimate(_ptr(pos), pos.stride(0), n, _ptr(w),
                                _ptr(boxes), _ptr(partials),
                                _ptr(_tickets(pos.device, b)), _ptr(est), b,
                                _stream(pos.device))
    _check_rc(rc, "bai_breen_estimate")
    launch_counts["bai_breen_estimate"] += 1
    return _squeeze_like(est, positions)


# ---------------------------------------------------------------- K2: refine


def bai_breen_refine_plain(pos, weights, boxes, est):
    """Twin of K2: unwrap [B, N, 3] around est [B, 3], weighted mean."""
    L = boxes[:, None, :]
    e = est[:, None, :]
    half = L * 0.5
    d = pos - e + half
    u = e + (d - L * torch.floor(d / L) - half)
    if weights is None:
        return u.sum(1) / torch.full((), float(pos.shape[1]), device=pos.device)
    return (weights[None, :, None] * u).sum(1) / weights.sum()


def bai_breen_refine(positions, weights, box, est):
    """K2: refined centre around a K1 estimate, one launch per call.

    positions [N, 3] or [B, N, 3]; weights [N] or None (ones); box
    broadcastable to [B, 3]; est [3] or [B, 3] -> [3] or [B, 3].  The
    kernel shares K1's ticket buffer (`_tickets`)."""
    kernel = _on_kernel(positions, weights, box, est)
    pos = _frames(positions)
    b, n = pos.shape[0], pos.shape[1]
    boxes = _boxes(box, b, pos)
    w = _weights(weights, n, pos)
    est = torch.as_tensor(est, dtype=torch.float32, device=pos.device)
    est = est.reshape(-1, 3).expand(b, 3).contiguous()
    if not kernel:
        return _squeeze_like(bai_breen_refine_plain(pos, w, boxes, est), positions)
    lib = _load()
    tiles = max(1, -(-n // lib.gk_bb_refine_tile()))
    partials = torch.empty((b, tiles, 4), dtype=torch.float32, device=pos.device)
    out = torch.empty((b, 3), dtype=torch.float32, device=pos.device)
    with torch.cuda.device(pos.device):
        rc = lib.gk_bb_refine(_ptr(pos), pos.stride(0), n, _ptr(w),
                              _ptr(boxes), _ptr(est), _ptr(partials),
                              _ptr(_tickets(pos.device, b)), _ptr(out), b,
                              _stream(pos.device))
    _check_rc(rc, "bai_breen_refine")
    launch_counts["bai_breen_refine"] += 1
    return _squeeze_like(out, positions)


def bai_breen_center_plain(pos, weights, boxes):
    """Twin of K1 + K2 as `pallas_kernels.bai_breen_center` composes them:
    geometric estimate over the atoms with w > 0, then the w-weighted
    refine."""
    geo = None if weights is None else (weights > 0).to(torch.float32)
    return bai_breen_refine_plain(
        pos, weights, boxes, bai_breen_estimate_plain(pos, geo, boxes))


def bai_breen_center(positions, weights, box):
    """K1 + K2: refined Bai-Breen centre (`pallas_kernels.bai_breen_center`
    semantics, batched over frames)."""
    geo = None if weights is None else (
        torch.as_tensor(weights) > 0).to(torch.float32)
    est = bai_breen_estimate(positions, geo, box)
    return bai_breen_refine(positions, weights, box, est)


# ---------------------------------------------------------------- K3: pair reduce


def pair_reduce_plain(a, b, boxes, cutoff: float, chunk_pairs: int = 1 << 24):
    """Twin of K3 over [B, N, 3] x [B, M, 3] frames and [B, 3] boxes ->
    (min distance [B] float32, count of d2 < cutoff^2 [B] int64).

    Chunked over a's atoms so that no more than `chunk_pairs` pair
    distances exist at once; the N x M matrix is never built."""
    nb, n, m = a.shape[0], a.shape[1], b.shape[1]
    L = boxes[:, None, None, :]
    c = torch.tensor(float(cutoff), dtype=torch.float32, device=a.device)
    cut2 = c * c
    dmin = torch.full((nb,), math.inf, dtype=torch.float32, device=a.device)
    cnt = torch.zeros(nb, dtype=torch.int64, device=a.device)
    step = max(1, chunk_pairs // max(1, nb * m))
    for i0 in range(0, n, step):
        d = a[:, i0:i0 + step, None, :] - b[:, None, :, :]
        d = d - L * torch.floor(d / L + 0.5)
        d2 = d[..., 0] * d[..., 0]
        d2 = d2 + d[..., 1] * d[..., 1]
        d2 = d2 + d[..., 2] * d[..., 2]
        dmin = torch.minimum(dmin, d2.amin(dim=(1, 2)))
        cnt += (d2 < cut2).sum(dim=(1, 2))
    return torch.sqrt(dmin), cnt


def pair_reduce(a, b, box, cutoff: float):
    """K3: minimum PBC distance and contact count between two atom sets.

    a [N, 3] or [B, N, 3]; b [M, 3] or [B, M, 3] float32; box broadcastable
    to [B, 3]; cutoff: contacts are pairs with d2 < cutoff^2.  Returns
    (min distance, count) as float32 and int64, shaped [] or [B]."""
    kernel = _on_kernel(a, b, box)
    pa = _frames(a, "a")
    pb = _frames(b, "b")
    nb = pa.shape[0]
    if pb.shape[0] != nb:
        raise ValueError(f"a has {nb} frames, b has {pb.shape[0]}")
    boxes = _boxes(box, nb, pa)
    n, m = pa.shape[1], pb.shape[1]
    if not kernel:
        dmin, cnt = pair_reduce_plain(pa, pb, boxes, cutoff)
    else:
        lib = _load()
        bits = torch.full((nb,), 0x7F800000, dtype=torch.int32, device=pa.device)
        cnt = torch.zeros(nb, dtype=torch.int64, device=pa.device)
        with torch.cuda.device(pa.device):
            rc = lib.gk_pair_reduce(_ptr(pa), pa.stride(0), n, _ptr(pb),
                                    pb.stride(0), m, _ptr(boxes),
                                    float(cutoff), _ptr(bits), _ptr(cnt), nb,
                                    _stream(pa.device))
        _check_rc(rc, "pair_reduce")
        launch_counts["pair_reduce"] += 1
        dmin = torch.sqrt(bits.view(torch.float32))
    if a.dim() == 2:
        return dmin[0], cnt[0]
    return dmin, cnt
