"""Hydrogen-bond kinetics of the PyTorch port (`models.hbond_acf`,
`models.hbond_lifetime`) against groan_rs_tpu's, on the CPU: the seeded
3,000-atom synthetic system in a 3 nm box (liquid water's density, as
`tests/test_torch_hbonds.py` builds it) with the full topology, 12 frames,
water (OW / OW / HW1 HW2) and lipid (C / C / H) chains.

The existence matrices hold the same bonds (columns compared as a set:
bond identity is (pair, donor, hydrogen, acceptor), and the curves do not
depend on column order), the curves and lifetimes are equal, and
`hbond_acf(continuous=False)` is `hbond_lifetime`'s intermittent curve bit
for bit.  A System on the CPU detects on the CPU.  Errors raise the JAX
package's class and code."""

import numpy as np
import pytest

from groan_rs_tpu import models as J
from groan_rs_tpu.models import dynamics as JD
from groan_rs_tpu.system import hbonds as jh

from _torch_parity import jax_system, raised, state_from_jax_system
from groan_rs_tpu_torch import convert, testing
from groan_rs_tpu_torch import models as T
from groan_rs_tpu_torch.models import dynamics as TD
from groan_rs_tpu_torch.system import hbonds as th

N_ATOMS, N_FRAMES, BOX = 3000, 12, 3.0
WATER = ("name OW", "name OW", "name HW1 HW2")
LIPID = ("name C", "name C", "name H")
SETS = {"water": ([WATER], [(0, 0)]),
        "water-lipid": ([WATER, LIPID], [(0, 0), (0, 1), (1, 1)])}


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    from groan_rs_tpu_torch.io import native

    xtc = str(tmp_path_factory.mktemp("hbk") / "synthetic.xtc")
    testing.build_trajectory(xtc, N_ATOMS, N_FRAMES, box_len=BOX)
    offs, _, _, nat = native.xtc_scan(xtc)
    c0, b9, *_ = native.xtc_read_frames(xtc, offs[:1], nat)
    state = testing.synthetic_state(c0[0], b9[0][[0, 4, 8]], topology="full")
    jsys = jax_system(state)
    tsys = convert.system_from_state(
        state_from_jax_system(jsys, ("Protein", "Membrane", "Peptide", "Water")), device="cpu")
    return xtc, jsys, tsys


def _chains(mod, specs):
    return [mod.HBondChain(*s) for s in specs]


def _columns(h):
    """The existence matrix's columns as a sorted list of frame patterns."""
    return sorted(map(bytes, np.asarray(h, bool).T.copy()))


@pytest.mark.parametrize("chains", list(SETS))
def test_existence_matrix(systems, chains):
    xtc, js, ts = systems
    specs, pairs = SETS[chains]
    jt, jh_ = JD._hbond_h_matrix(js, xtc, _chains(jh, specs), pairs, 0.35, 120.0, 5,
                                 "hbond_acf")
    tt, th_ = TD._hbond_h_matrix(ts, xtc, _chains(th, specs), pairs, 0.35, 120.0, 5,
                                 "hbond_acf")
    assert np.array_equal(jt, tt)
    assert th_.shape == jh_.shape and th_.shape[0] == N_FRAMES and th_.shape[1] > 100
    assert _columns(th_) == _columns(jh_)


@pytest.mark.parametrize("chains", list(SETS))
@pytest.mark.parametrize("continuous", [False, True])
def test_hbond_acf(systems, chains, continuous):
    xtc, js, ts = systems
    specs, pairs = SETS[chains]
    jt, jc = J.hbond_acf(js, xtc, _chains(jh, specs), pairs, continuous=continuous)
    tt, tc = T.hbond_acf(ts, xtc, _chains(th, specs), pairs, continuous=continuous)
    assert np.array_equal(jt, tt) and np.array_equal(jc, tc)
    assert tc[0] == 1.0
    if continuous:                 # a bond that persists tau frames persisted tau - 1
        assert (np.diff(tc) <= 1e-12).all()


@pytest.mark.parametrize("chains", list(SETS))
def test_hbond_lifetime(systems, chains):
    xtc, js, ts = systems
    specs, pairs = SETS[chains]
    a = J.hbond_lifetime(js, xtc, _chains(jh, specs), pairs)
    b = T.hbond_lifetime(ts, xtc, _chains(th, specs), pairs)
    assert set(a) == set(b)
    for key, v in a.items():
        assert np.array_equal(np.asarray(b[key]), np.asarray(v)), key
    _, ci = T.hbond_acf(ts, xtc, _chains(th, specs), pairs)
    assert np.array_equal(ci, b["intermittent"])
    want = (np.diff(b["lag_times"]) * (ci[1:] + ci[:-1]) / 2).sum()
    assert b["tau_intermittent"] == want


@pytest.mark.parametrize("case", ["one frame", "no bonds", "window", "stride"])
def test_errors_and_options(systems, case):
    xtc, js, ts = systems
    kw = {"one frame": {"end_time": 0.0}, "no bonds": {"max_distance": 0.01},
          "window": {"start_time": 20.0, "end_time": 80.0}, "stride": {"step": 3}}[case]
    a = raised(lambda: J.hbond_lifetime(js, xtc, _chains(jh, [WATER]), [(0, 0)], **kw))
    b = raised(lambda: T.hbond_lifetime(ts, xtc, _chains(th, [WATER]), [(0, 0)], **kw))
    assert a == b
    if case in ("window", "stride"):
        assert b is None
        x = J.hbond_lifetime(js, xtc, _chains(jh, [WATER]), [(0, 0)], **kw)
        y = T.hbond_lifetime(ts, xtc, _chains(th, [WATER]), [(0, 0)], **kw)
        assert np.array_equal(x["continuous"], y["continuous"])
        assert np.array_equal(x["lag_times"], y["lag_times"])
    else:
        assert b is not None and b[0] == "ParallelError"
