"""PyTorch + CUDA port of the trajectory-analysis engine.

Mirrors the paths and public names of `groan_rs_tpu` for what it covers:
building a System from GRO, PDB or PQR files with GSL groups, NDX files
and element guessing; the System's own API (per-frame iteration over
XTC, TRR and GRO trajectories, analysis, modifying and RMSD methods,
atom iterators, shapes, trajectory writers, `traj_iter_map_reduce`),
computing on the CUDA card unless built with `device="cpu"`; the
per-frame observables of `TrajectoryAnalysis` (orthorhombic and
triclinic, from positions and from TRR velocities), streamed or
device-resident.  Plain tensor code
is PyTorch; the three kernels the JAX package wrote in Pallas
(`groan_rs_tpu/ops/pallas_kernels.py`) are hand-written CUDA C++ for
Hopper under `csrc/`, each with a plain PyTorch twin that the CPU runs.

This package imports torch and numpy only — never jax, never
`groan_rs_tpu` — so it runs on a GPU host without JAX installed.

    from groan_rs_tpu_torch import System
    from groan_rs_tpu_torch.models import TrajectoryAnalysis
    system = System.from_file("system.gro")
    system.guess_elements()
    system.group_create("Protein", "@protein")
    system.group_create("Membrane", "@membrane")
    for frame in system.xtc_iter("traj.xtc"):      # the reference's loop
        com = frame.group_get_com("Protein")
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
from .core.gridmap import GridMap
from .system import System

__all__ = ["backend", "require_cuda", "Dimension", "GridMap", "System"]
