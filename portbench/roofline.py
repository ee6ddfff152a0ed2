"""Peak rates of the card and the work of each operation a roofline share
times, counted from shapes by the algorithm.

The peaks and the K3 count are frozen from `chip_smoke.py` at commit
14410646bb8b46a8e0fcf9fa6d0b96e5dfbab158 (`HBM_BYTES_S`, `FP32_OPS_S`,
`K3_OPS_PER_PAIR`, `bound`, `k1_bound`, `k2_bound`, `k3_bound`).  A share
is the least time the card could take (the larger of operations over the
FP32 rate and bytes over the HBM rate) over the time measured around the
public operation, so it reads the same work whatever implements it.
Bytes count each input read once and each output written once; operations
count what the algorithm needs per pair or per atom, never what one
implementation executes (no 27 images, no second read of the positions).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit: HBM3 3.35 TB/s;
# 67 TFLOP/s FP32 outside the tensor cores counts an FMA as two, so
# 3.35e13 FP32 instructions/s (132 SMs x 128 lanes x 1.98 GHz).
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12 / 2

# The orthorhombic minimum-image distance squared of one pair: per axis
# sub, mul by 1/L, add 0.5, round, mul by L, sub, square (7 x 3 = 21), two
# adds of the squares (23); then the running minimum (24) and the
# comparison with the cutoff (25).
MIN_IMAGE_OPS = 21 + 2
PAIR_MIN_OPS = MIN_IMAGE_OPS + 2                  # = K3_OPS_PER_PAIR, 25

# The triclinic (lower-triangular box) minimum image of one pair, taken
# axis by axis from z as GROMACS does: per axis a mul by the inverse
# diagonal and a round (2), then the shift subtracted along the box row:
# 3 FMAs for z, 2 for y, 1 for x, two instructions each as above (12);
# the differences (3), the squares and their sum (5), the running
# minimum (1): 6 + 12 + 3 + 5 + 1 = 27.  A dodecahedron needs more for an
# exact image; this is the least, so the share is a lower bound.
TRICLINIC_PAIR_MIN_OPS = 27

# The RDF histogram of one pair: the distance squared (23), a square root
# (1), the bin ceil(d / dr) - 1 (mul, ceil, sub: 3), the range checks
# d > 0 and bin < n (2), the count (1).
RDF_PAIR_OPS = MIN_IMAGE_OPS + 1 + 3 + 2 + 1        # = 30

# The refined centre of one atom: the estimate (K1: per coordinate wrap 4,
# angle 1, sin and cos 2, weighted sums 4 -> 33, + the weight sum 1) and
# the unwrap-and-mean (K2: per coordinate unwrap 8, weighted sum 2 -> 30,
# + the weight sum 1).
CENTER_ATOM_OPS = (3 * 11 + 1) + (3 * 10 + 1)       # = 65


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least seconds for the work, "bytes" or "operations")."""
    t_b, t_o = nbytes / HBM_BYTES_S, ops / FP32_OPS_S
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def pair_min_work(b: int, n: int, m: int, box_floats: int = 3,
                  ops_per_pair: int = PAIR_MIN_OPS) -> tuple[float, float]:
    """(bytes, operations) of a per-frame pair reduction of [b, n, 3] and
    [b, m, 3] float32 positions: positions and boxes read once, one float
    out per frame."""
    nbytes = b * (n + m) * 3 * 4 + b * box_floats * 4 + b * 4
    return nbytes, float(ops_per_pair) * b * n * m


def rdf_work(b: int, n: int, m: int, n_bins: int) -> tuple[float, float]:
    """(bytes, operations) of the pair-distance histogram: positions and
    boxes read once, b x n_bins int64 counts written once."""
    nbytes = b * (n + m) * 3 * 4 + b * 3 * 4 + b * n_bins * 8
    return nbytes, float(RDF_PAIR_OPS) * b * n * m


def center_work(b: int, n: int, weighted: bool) -> tuple[float, float]:
    """(bytes, operations) of the refined centre of [b, n, 3] float32
    positions: positions (and float32 weights) and boxes read once, the
    [b, 3] centres written once."""
    nbytes = b * n * 12 + (n * 4 if weighted else 0) + b * 12 + b * 12
    return nbytes, float(CENTER_ATOM_OPS) * b * n


def share_pct(work: tuple[float, float], seconds: float) -> float:
    """Percent of the roofline: least time over measured time."""
    return 100.0 * bound(*work)[0] / seconds
