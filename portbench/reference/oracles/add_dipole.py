"""`add_dipole`: the dipole moment of a group about its centre of mass, relative,
forgiving any subset of the frame's candidate image flips."""

import torch

from portbench.reference import plain as P

KIND = "flipvec"


def oracle(fr, args, kwargs, tol):
    g = fr.groups[args[0]]
    want, deltas = P.dipole_flips(fr.group(args[0]), fr.box, fr.charge[g], fr.weights(args[0]))
    return want, deltas if tol else torch.zeros_like(deltas[:, :0])
