"""`add_dihedrals`: the dihedrals of the index table `args[0]["site"]` (degrees,
modulo 360), in float32 ulps over their arm."""

import torch

from portbench.reference import plain as P
from portbench.reference.frames import sites, ulp_nm

KIND = "cond"


def oracle(fr, args, kwargs, tol):
    q = sites(fr, args[0]["site"])
    want, arm = P.dihedrals(*(fr.p[:, q[:, k]] for k in range(4)), fr.box)
    return want, torch.rad2deg(ulp_nm(fr) / arm), 360.0
