"""`add_in_shape`: the count of a group's atoms inside the generator's z cylinder:
(lo, hi) bounds, an atom within `tol` of its surface counting in `hi`
only."""

from portbench.reference import plain as P

KIND = "bounds"


def oracle(fr, args, kwargs, tol):
    pos, radius, height = fr.syn.cylinder_args()
    return P.in_cylinder(fr.group(args[0]), fr.box, pos, radius, height, tol)
