"""`add_total_dipole`: the summed dipole of whole molecules of three atoms (water),
relative."""

import torch

from portbench.reference import plain as P

KIND = "rel"


def oracle(fr, args, kwargs, tol):
    g = fr.groups[args[0]]
    n = g.stop - g.start
    first = torch.div(torch.arange(n, device=fr.p.device), 3, rounding_mode="floor") * 3
    return P.total_dipole(fr.group(args[0]), fr.box, fr.charge[g], first)
