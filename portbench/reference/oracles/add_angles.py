"""`add_angles`: the angles of the index table `args[0]["site"]` (degrees), in
float32 ulps over their arm."""

import torch

from portbench.reference import plain as P
from portbench.reference.frames import sites, ulp_nm

KIND = "cond"


def oracle(fr, args, kwargs, tol):
    t = sites(fr, args[0]["site"])
    want, arm = P.angles(fr.p[:, t[:, 0]], fr.p[:, t[:, 1]], fr.p[:, t[:, 2]], fr.box)
    return want, torch.rad2deg(ulp_nm(fr) / arm)
