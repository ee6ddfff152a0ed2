"""`add_principal`: the principal moments of inertia, relative, against the nearest
of their values under the frame's candidate image flips."""

from portbench.reference import plain as P

KIND = "fliprel"


def oracle(fr, args, kwargs, tol):
    if not tol:
        want = P.principal(fr.group(args[0]), fr.box, fr.weights(args[0]))
        return want, want[:, None]
    values = P.principal_flips(fr.group(args[0]), fr.box, fr.weights(args[0]))
    return values[:, 0], values
