"""`add_gyration`: the mass-weighted radius of gyration (with `components`, also
per axis), relative to the frame's largest."""

from portbench.reference import plain as P

KIND = "rel"


def oracle(fr, args, kwargs, tol):
    g = P.gyration(fr.group(args[0]), fr.box, fr.weights(args[0]))
    return g if kwargs.get("components") else g[:, 0]
