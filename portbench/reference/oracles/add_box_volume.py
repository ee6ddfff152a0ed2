"""`add_box_volume`: the box volume (nm^3), relative."""

from portbench.reference import plain as P

KIND = "rel"


OUTPUT = "box_volume"


def oracle(fr, args, kwargs, tol):
    return P.box_volume(fr.box)
