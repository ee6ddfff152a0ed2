"""`add_contacts`: the count of atom pairs of two groups within a cutoff: (lo, hi)
bounds, a pair within `tol` of the cutoff counting in `hi` only."""

KIND = "bounds"


def oracle(fr, args, kwargs, tol):
    cutoff = args[2] if len(args) > 2 else kwargs["cutoff"]
    return fr.pairs(args[0], args[1], tol)[1][float(cutoff)]
