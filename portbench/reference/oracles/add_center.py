"""`add_center`: the refined centre of geometry of a group (nm)."""

from portbench.reference.frames import center

KIND = "gap"


def oracle(fr, args, kwargs, tol):
    return center(fr, args[0], False)
