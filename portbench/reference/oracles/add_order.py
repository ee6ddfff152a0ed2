"""`add_order`: the lipid C-H order parameters along z, in float32 ulps over the
bond (`|dS| <= 1.5 |d theta|`, `d theta ~ ulp / bond length`)."""

from portbench.reference import plain as P
from portbench.reference.frames import sites, ulp_nm

KIND = "cond"


def oracle(fr, args, kwargs, tol):
    hyd = sites(fr, "lipid_hydrogens")
    want, length = P.order(fr.p[:, hyd - 1], fr.p[:, hyd], fr.box)
    return want, 1.5 * ulp_nm(fr) / length
