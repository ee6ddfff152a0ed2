"""The comparison that decides `correct` fails where it must: the control
(the plain reference computed in TF32, the step below the configuration's
float32 with TF32 off) in the program's place, and the program with its
timed path broken underneath.  At a size a test run holds, on the CPU;
the control's readings at the cells' own sizes come from
`calibrate.py` on the card (PERF.md)."""

import time

import numpy as np
import pytest

from portbench.conftest import tiny
from portbench import harness
from portbench.calibrate import control_numbers

CELLS = ["main-resident", "observables-streamed", "main-dodec-streamed"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell, config, traffic = tiny(name)
    limits = cell["limits"]
    for seed in (2**31 + 1, 2**32 + 7):
        numbers = control_numbers(config, traffic, seed, "cpu")
        assert set(numbers) == set(limits)
        assert [k for k in limits if numbers[k] > limits[k]], (name, numbers)


def _unchanged(v, batch):
    """The step never advances: every batch returns the first batch's answers."""
    out = v.copy()
    for b0 in range(batch, len(v), batch):
        n = min(batch, len(v) - b0)
        out[b0:b0 + n] = v[:n]
    return out


def _half_batch(v, batch):
    """Half of each batch left out: its frames take the other half's answers."""
    out = v.copy()
    for b0 in range(0, len(v), batch):
        h = batch // 2
        n = min(h, len(v) - b0 - h)
        if n > 0:
            out[b0 + h:b0 + h + n] = v[b0:b0 + n]
    return out


def _altered(v, batch):
    """One answer altered where it is produced (frame 1)."""
    out = v.copy()
    if out.dtype.kind in "iu":
        out[1] += 1
    else:
        out[1] = out[1] * (1 + 1e-3) + 1e-3
    return out


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    """The run as the driver makes it, but for the look for a card, with the
    program's pass broken underneath: `correct` comes out false."""
    from groan_rs_tpu_torch.models.pipeline import PipelineRunner

    from portbench.reference.judge import output_name

    cell, config, traffic = tiny(name)
    outs = [output_name(c) for c in traffic["analysis"]]
    run = PipelineRunner.run

    def broken(self, *a, **kw):
        got = run(self, *a, **kw)
        for k in outs:
            got[k] = FAULTS[fault](np.asarray(got[k]), traffic["batch"])
        return got

    monkeypatch.setattr(PipelineRunner, "run", broken)
    res = harness.run_cell(cell, config, traffic, 2**31 + 3, 0.2, False, "cpu",
                           time.perf_counter())
    assert res["correct"] is False and res["failed"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    cell, config, traffic = tiny(name)
    res = harness.run_cell(cell, config, traffic, 2**31 + 3, 0.2, False, "cpu",
                           time.perf_counter())
    assert res["correct"] is True, res["checks"]
