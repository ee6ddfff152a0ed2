"""`add_rmsd`: the mass-weighted fitted RMSD of a group against frame 0 (nm),
against the nearest of its values under the frame's candidate image
flips (`plain.kabsch_rmsd_flips`)."""

from portbench.reference import plain as P

KIND = "flips"


def oracle(fr, args, kwargs, tol):
    g = fr.groups[args[0]]
    a = (fr.ref_frame()[g], fr.ref_box(), fr.group(args[0]), fr.box, fr.weights(args[0]))
    want = P.kabsch_rmsd(*a)
    if not tol:
        return want, want[:, None]
    values = P.kabsch_rmsd_flips(*a)
    # the sums' form of column 0 rounds apart from the direct form by ~1e-8
    return want, values + (want - values[:, 0])[:, None]
