"""`add_com`: the mass-weighted refined centre of a group (nm)."""

from portbench.reference.frames import center

KIND = "gap"


def oracle(fr, args, kwargs, tol):
    return center(fr, args[0], True)
