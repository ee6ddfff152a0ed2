"""`add_density_map`: a group's 2-D number map over a plane: items outside the (lo, hi)
bounds, an atom within `tol` of a tile edge counting in `hi` only."""

import numpy as np

from portbench.reference import plain as P
from portbench.reference.frames import AXES

KIND = "bounds"


def oracle(fr, args, kwargs, tol):
    plane = kwargs.get("plane", "xy")
    axes = (AXES[plane[0]], AXES[plane[1]])
    tile = kwargs.get("tile", 0.1)
    lengths = np.diag(fr.syn.h).astype(np.float64)
    span = kwargs.get("span") or ((0.0, lengths[axes[0]]), (0.0, lengths[axes[1]]))
    nx = int(round((span[0][1] - span[0][0]) / tile))
    ny = int(round((span[1][1] - span[1][0]) / tile))
    return P.density_map(fr.group(args[0]), axes, span, nx, ny, tol)
