"""`add_distance`: the minimum-image distance between two groups' centres (nm);
`com` a bool or a pair of bools (mass-weighted each)."""

import torch

from portbench.reference import plain as P
from portbench.reference.frames import center

KIND = "abs"


def oracle(fr, args, kwargs, tol):
    com = kwargs.get("com", False)
    c1, c2 = (com, com) if isinstance(com, bool) else com
    d = P.min_image((center(fr, args[0], c1) - center(fr, args[1], c2))[:, None, :], fr.box)
    return torch.sqrt((d[:, 0] ** 2).sum(-1))
