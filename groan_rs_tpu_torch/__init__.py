"""PyTorch + CUDA port of the trajectory-analysis engine.

Mirrors the paths and public names of `groan_rs_tpu` for the slice it
covers (the 1M-atom COM / distance / RMSD / min-distance pass and its
device-resident re-run).  Plain tensor code is PyTorch; the three kernels
the JAX package wrote in Pallas (`groan_rs_tpu/ops/pallas_kernels.py`)
are hand-written CUDA C++ for Hopper under `csrc/`, each with a plain
PyTorch twin that the CPU runs.

This package imports torch and numpy only — never jax, never
`groan_rs_tpu` — so it runs on a GPU host without JAX installed.

    from groan_rs_tpu_torch.models import TrajectoryAnalysis
    out = (TrajectoryAnalysis(system)
           .add_com("Protein")
           .add_distance("Protein", "Membrane", com=(True, False))
           .add_rmsd("Protein", reference=system)
           .runner().run("traj.xtc"))
"""

from __future__ import annotations

from . import backend
from .backend import require_cuda
from .core.dimension import Dimension
from .system import System

__all__ = ["backend", "require_cuda", "Dimension", "System"]
