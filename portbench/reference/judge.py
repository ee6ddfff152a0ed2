"""The comparison that decides `correct`: each output of a cell's analysis
against its plain oracle, frame block by frame block.

A cell's traffic file lists the analysis as calls (`{"call": "add_com",
"args": ["Protein"], "kwargs": {"name": "com"}}`); the oracle of each
call is the file `oracles/<call>.py`, found by the call's name (see
`oracles/__init__.py`).  Its `KIND` names the number compared:

- `gap`: largest component of the minimum image of got - want (a centre
  is defined up to a box vector), nm;
- `abs`: largest |got - want|;
- `rel`: largest |got - want| over the largest |want| of the frame;
- `cond`: for angles, dihedrals and order parameters, each item's
  |got - want| (modulo the oracle's period, where it gives one) over its
  float32 sensitivity: what one float32 ulp of a coordinate at the box's
  longest edge moves the item by, given its arm (a bond length, a lever
  arm); an item undefined in the oracle (NaN) must be NaN in the program
  too (inf otherwise).  Near-collinear sites on the coordinate grid have
  arms near zero, where any float answer is right;
- `flips`, `flipvec`, `fliprel`: `abs` (the RMSD) or `rel` (the dipole,
  the principal moments) against the nearest of the oracle's values
  under every subset of the frame's candidate image flips: atoms within
  `plain.FLIP_TOL` of the wrap around the centre may take either image in
  float32, as a count's items near an edge may fall in either bin;
- `bounds`: items outside the oracle's (lo, hi) count bounds;
- `slack_rel`: `rel` after the oracle's slack (weights within reach of a
  slab edge) is taken off.

An oracle file may bring a comparison of its own (`error`).
`judge_block` folds the numbers of every block and output;
`control_outputs` gives the control's own outputs in the program's form.
"""

from __future__ import annotations

import importlib.util
import math
import os

import torch

from . import plain as P
from .frames import Frames  # noqa: F401  (the type the oracles read)

TOL = 1e-5          # nm: an item this close to an edge or boundary may go either way
ORACLE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "oracles")
_loaded = {}


def oracle(call: str):
    """The module `oracles/<call>.py`."""
    path = os.path.join(ORACLE_DIR, f"{call}.py")
    if path not in _loaded:
        if not os.path.exists(path):
            raise KeyError(f"no oracle for the call '{call}' ({path})")
        spec = importlib.util.spec_from_file_location(f"portbench_oracle_{call}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]


def oracle_names() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(ORACLE_DIR)
                  if f.endswith(".py") and not f.startswith("_"))


def output_name(call: dict) -> str:
    kw = call.get("kwargs", {})
    return kw["name"] if "name" in kw else oracle(call["call"]).OUTPUT


def _gap(got, want, fr):
    d = P.min_image((got.to(torch.float64) - want.to(torch.float64))[:, None, :],
                    fr.box.to(torch.float64))
    return float(d.abs().max())


def _abs(got, want, fr):
    return float((got.to(torch.float64) - want.to(torch.float64)).abs().max())


def _rel(got, want, fr):
    got, want = got.to(torch.float64), want.to(torch.float64)
    f = got.shape[0]
    gap = (got - want).reshape(f, -1).abs().amax(1)
    scale = want.reshape(f, -1).abs().amax(1).clamp_min(1e-30)
    return float((gap / scale).max())


def _cond(got, want, fr):
    want, scale, *period = want
    got, want = got.to(torch.float64), want.to(torch.float64)
    undefined = ~torch.isfinite(want)
    if not torch.equal(~torch.isfinite(got), undefined):
        return math.inf
    gap = got - want
    if period:
        gap = gap - torch.round(gap / period[0]) * period[0]
    gap = (gap.abs() / scale.to(torch.float64))[~undefined]
    return float(gap.max()) if gap.numel() else 0.0


def _flips(got, want, fr):
    _, values = want
    gap = (got.to(torch.float64)[:, None] - values.to(torch.float64)).abs()
    return float(gap.amin(1).max())


def _fliprel(got, want, fr):
    want, values = (x.to(torch.float64) for x in want)
    gap = (got.to(torch.float64)[:, None] - values).abs().amax(-1).amin(1)
    return float((gap / want.abs().amax(-1).clamp_min(1e-30)).max())


def _flipvec(got, want, fr):
    want, deltas = (x.to(torch.float64) for x in want)
    gap = got.to(torch.float64) - want                                  # [F, 3]
    sums = torch.einsum("sk,fkj->fsj", P.subsets(deltas.shape[1], gap), deltas)
    resid = (gap[:, None, :] - sums).abs().amax(2).amin(1)              # [F]
    scale = want.abs().amax(1).clamp_min(1e-30)
    return float((resid / scale).max())


def _bounds(got, want, fr):
    lo, hi = want
    got = got.to(torch.int64).reshape(lo.shape)
    return float(((got < lo) | (got > hi)).sum())


def _slack_rel(got, want, fr):
    prof, slack = (x.to(torch.float64) for x in want)
    gap = torch.clamp((got.to(torch.float64) - prof).abs() - slack, min=0.0)
    return float((gap.amax(1) / prof.abs().amax(1).clamp_min(1e-30)).max())


ERRORS = {"gap": _gap, "abs": _abs, "rel": _rel, "cond": _cond, "flips": _flips,
          "fliprel": _fliprel, "flipvec": _flipvec, "bounds": _bounds,
          "slack_rel": _slack_rel}
# the kinds whose oracle gives (the answer, what the comparison forgives)
_FIRST = ("bounds", "slack_rel", "cond", "flips", "flipvec", "fliprel")


def error(kind, got, want, fr=None) -> float:
    """The number compared for one block: see the module docstring."""
    if kind not in ERRORS:
        raise ValueError(f"unknown comparison '{kind}'")
    return ERRORS[kind](got, want, fr)


def _want(call: dict, fr: Frames, tol: float):
    return oracle(call["call"]).oracle(fr, call.get("args", []), call.get("kwargs", {}), tol)


def reference_outputs(fr: Frames, analysis, tol=TOL) -> dict:
    """{output name: want} of the block `fr`."""
    return {output_name(c): _want(c, fr, tol) for c in analysis}


def judge_block(got: dict, fr: Frames, analysis, numbers: dict, want=None) -> None:
    """Fold this block's numbers into `numbers` {output: worst so far};
    `got` {output: program's [F, ...] tensor for these frames}; `want`
    the block's `reference_outputs` when already made."""
    want = reference_outputs(fr, analysis) if want is None else want
    for c in analysis:
        name, mod = output_name(c), oracle(c["call"])
        if hasattr(mod, "error"):
            e = mod.error(got[name], want[name], fr, c)
        else:
            e = error(mod.KIND, got[name], want[name], fr)
        numbers[name] = max(numbers.get(name, 0.0), e)


def control_outputs(fr: Frames, analysis) -> dict:
    """The control's outputs in the program's form: the oracles run on
    `fr` (TF32-rounded inputs, float32 arithmetic) with no edge reach."""
    out = {}
    for c in analysis:
        mod = oracle(c["call"])
        w = _want(c, fr, 0.0)
        if hasattr(mod, "control"):
            w = mod.control(fr, c.get("args", []), c.get("kwargs", {}), w)
        elif mod.KIND in _FIRST:
            w = w[0]
        out[output_name(c)] = w
    return out
