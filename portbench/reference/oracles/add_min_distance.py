"""`add_min_distance`: the minimum distance between two groups' atoms (nm)."""

KIND = "abs"


def oracle(fr, args, kwargs, tol):
    return fr.pairs(args[0], args[1], tol)[0]
