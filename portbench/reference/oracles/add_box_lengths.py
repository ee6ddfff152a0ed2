"""`add_box_lengths`: the box lengths (nm), relative."""

from portbench.reference import plain as P

KIND = "rel"


OUTPUT = "box_lengths"


def oracle(fr, args, kwargs, tol):
    return P.box_lengths(fr.box)
