"""Per-call System analysis on one device: host numpy in, numpy out.

Port of `groan_rs_tpu/ops/interactive.py:119-217`.  The System keeps its
frame in host numpy (a trajectory iterator writes every frame there);
each call moves the rows it needs to the System's device, runs the same
ops the batched pass runs (the refined centre is K1 + K2 on CUDA tensors,
their plain twins on CPU tensors) and brings the small result back.  The
JAX module's CPU routing (`host()`, power-of-two padding and a jit cache)
exists for a remote TPU and is not ported: there is no compile to cache,
and the CUDA card is local.
"""

from __future__ import annotations

import numpy as np
import torch

from . import center as C
from . import distances as D
from . import pbc

__all__ = ["put", "fetch", "estimate_center", "center", "center_naive",
           "center_triclinic", "distance", "distance_triclinic",
           "distance_matrix"]


def put(x, device) -> torch.Tensor:
    """A float32 numpy array (or scalar list) as a tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def fetch(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _w(weights, device):
    return None if weights is None else put(weights, device)


def estimate_center(pos, box, weights=None, *, device) -> np.ndarray:
    return fetch(C.estimate_center(put(pos, device), put(box, device),
                                   weights=_w(weights, device)))


def center(pos, box, weights=None, *, device) -> np.ndarray:
    return fetch(C.center(put(pos, device), put(box, device),
                          weights=_w(weights, device)))


def center_naive(pos, weights=None, *, device) -> np.ndarray:
    return fetch(C.center_naive(put(pos, device), weights=_w(weights, device)))


def center_triclinic(pos, box_matrix, weights=None, *, device) -> np.ndarray:
    return fetch(C.center_triclinic(put(pos, device), put(box_matrix, device),
                                    weights=_w(weights, device)))


def distance(a, b, box, dim_mask=(True, True, True), *, device) -> np.ndarray:
    return fetch(pbc.distance(put(a, device), put(b, device), put(box, device),
                              dim_mask))


def distance_triclinic(a, b, box_matrix, *, device) -> np.ndarray:
    return fetch(pbc.distance_triclinic(put(a, device), put(b, device),
                                        put(box_matrix, device)))


def distance_matrix(a, b, box, dim_mask=(True, True, True), *, device) -> np.ndarray:
    return fetch(D.distance_matrix(put(a, device), put(b, device),
                                   put(box, device), dim_mask))
