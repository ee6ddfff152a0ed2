"""The per-frame converters and analyzers of the PyTorch port
(`models/convert.py`) against groan_rs_tpu's, on the CPU, over the
3,000-atom synthetic layout (bonded waters and lipids, many broken across
the box) and its 12-frame XTC, in the 21 nm cube and in the rhombic
dodecahedron: `convert_iter` with each converter and with a chain of
them (in the dodecahedron every converter but the unwrapper refuses the
box, as in the JAX package), `analyze_iter` with a `FrameAnalyze` and
with a plain function.

Tolerances: positions 1e-5 nm on every frame (every atom of the System);
the analyzers' values 1e-5."""

import numpy as np
import pytest

from groan_rs_tpu.core.dimension import Dimension as JDim
from groan_rs_tpu.models import convert as J

from _torch_parity import named_pairs, raised
from groan_rs_tpu_torch.core.dimension import Dimension as TDim
from groan_rs_tpu_torch.models import convert as T


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return named_pairs(tmp_path_factory)


CHAINS = {
    "translate": lambda M, D, ref: [M.TranslateConverter([0.3, -1.2, 2.5])],
    "translate+wrap": lambda M, D, ref: [M.TranslateConverter([-4.0, 7.5, 30.0]),
                                         M.WrapConverter()],
    "fit": lambda M, D, ref: [M.FitConverter(ref, "Protein")],
    "make_whole": lambda M, D, ref: [M.MakeWholeConverter()],
    "center": lambda M, D, ref: [M.CenterConverter("Protein")],
    "center_mass_z": lambda M, D, ref: [M.CenterConverter("Membrane", D.Z,
                                                          mass_weighted=True)],
    "unwrap": lambda M, D, ref: [M.UnwrapConverter()],
    "whole+center+fit": lambda M, D, ref: [M.MakeWholeConverter(),
                                           M.CenterConverter("Protein"),
                                           M.FitConverter(ref, "Protein")],
}


def _frames(M, D, system, xtc, chain):
    ref = system.copy()
    return [s.positions.copy() for s in M.convert_iter(system.copy().xtc_iter(xtc),
                                                      CHAINS[chain](M, D, ref))]


@pytest.mark.parametrize("form", ["ortho", "triclinic"])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_convert_iter(pairs, form, chain):
    """Every chain runs in the cube; in the dodecahedron the converters
    that need an orthogonal box refuse it, in both packages the same way."""
    xtc, js, ts = pairs[form]
    want = raised(lambda: _frames(J, JDim, js, xtc, chain))
    if want is not None:
        assert form == "triclinic" and want[1] == "InvalidSimBox", want
        assert raised(lambda: _frames(T, TDim, ts, xtc, chain)) == want
        return
    want = _frames(J, JDim, js, xtc, chain)
    got = _frames(T, TDim, ts, xtc, chain)
    assert len(got) == len(want) == 12
    for f, (a, b) in enumerate(zip(want, got)):
        assert np.abs(b - a).max() <= 1e-5, (chain, f)


class _Com(T.FrameAnalyze):
    def analyze(self, system):
        return system.group_get_com("Protein")


class _JCom(J.FrameAnalyze):
    def analyze(self, system):
        return system.group_get_com("Protein")


def test_analyze_iter(pairs):
    xtc, js, ts = pairs["ortho"]
    want = [(v, s.positions[0].copy()) for s, v in J.analyze_iter(
        js.copy().xtc_iter(xtc), _JCom(), [J.CenterConverter("Protein")])]
    got = [(v, s.positions[0].copy()) for s, v in T.analyze_iter(
        ts.copy().xtc_iter(xtc), _Com(), [T.CenterConverter("Protein")])]
    for (va, pa), (vb, pb) in zip(want, got):
        assert np.abs(vb - va).max() <= 1e-5 and np.abs(pb - pa).max() <= 1e-5
    dist = [v for _, v in T.analyze_iter(ts.copy().xtc_iter(xtc),
                                         lambda s: s.group_distance("Protein", "Membrane",
                                                                    TDim.XYZ))]
    jdist = [v for _, v in J.analyze_iter(js.copy().xtc_iter(xtc),
                                          lambda s: s.group_distance("Protein", "Membrane",
                                                                     JDim.XYZ))]
    assert np.abs(np.asarray(dist) - np.asarray(jdist)).max() <= 1e-5
