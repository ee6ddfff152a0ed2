"""`add_density_profile`: a group's density profile along an axis (number, mass or charge),
relative, after the slack of weights within reach of a slab edge."""

import torch

from portbench.reference import plain as P
from portbench.reference.frames import AXES

KIND = "slack_rel"


SLAB_TOL = 1e-4     # nm: slab widths, the profiles' edge reach
SCALE = {"mass": 1.66053906660, "charge": 1.0, "number": 1.0}


def oracle(fr, args, kwargs, tol):
    g = fr.groups[args[0]]
    mode = kwargs.get("mode", "number")
    w = {"mass": fr.mass[g], "charge": fr.charge[g]}.get(
        mode, torch.ones(g.stop - g.start, dtype=fr.p.dtype, device=fr.p.device))
    axis = AXES[kwargs.get("axis", args[1] if len(args) > 1 else "z")]
    n_bins = kwargs.get("n_bins", args[2] if len(args) > 2 else 100)
    return P.density_profile(fr.group(args[0]), fr.box, axis, n_bins, w, SCALE[mode],
                             SLAB_TOL if tol else 0.0)
