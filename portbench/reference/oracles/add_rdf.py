"""`add_rdf`: the radial distribution g(r) of two groups.  The program's
g(r) times the ideal-gas pair counts gives its pair histogram, whose
items are compared against the oracle's (lo, hi) bounds: a pair within
`tol` of a bin edge may fall in either bin."""

import torch

from portbench.reference import plain as P

KIND = "bounds"


def oracle(fr, args, kwargs, tol):
    return P.pair_histogram(fr.group(args[0]), fr.group(args[1]), fr.box,
                            kwargs.get("r_max", 2.0), kwargs.get("n_bins", 200), tol)


def _ideal(fr, args, kwargs):
    """The ideal-gas pair counts [F, n_bins] (float64)."""
    g1, g2 = fr.groups[args[0]], fr.groups[args[1]]
    return P.rdf_ideal(fr.box.to(torch.float64), (g1.stop - g1.start) * (g2.stop - g2.start),
                       kwargs.get("r_max", 2.0), kwargs.get("n_bins", 200))


def error(got, want, fr, call):
    """Items of the program's pair histogram outside the bounds."""
    lo, hi = want
    counts = torch.round(got.to(torch.float64) * _ideal(fr, call["args"], call.get("kwargs", {})))
    return float(((counts < lo) | (counts > hi)).sum())


def control(fr, args, kwargs, want):
    """The control's histogram as the program's g(r)."""
    return (want[0].to(torch.float64) / _ideal(fr, args, kwargs)).to(torch.float32)
