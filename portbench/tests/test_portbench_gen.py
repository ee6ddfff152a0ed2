"""The input generator and the frozen XTC writer."""

import numpy as np
import torch

from portbench.conftest import tiny
from portbench.gen import xtc as xtcw
from portbench.gen.synthetic import Synthetic, seed_of


def _grid(config, seed, frames=None):
    syn = Synthetic(config, seed, "cpu", n_frames=frames)
    return syn, np.stack(list(syn.host_frames()))


def test_same_seed_same_bytes_new_seed_new_trajectory(tmp_path):
    _, config, _ = tiny("main-resident")
    blobs = []
    for i, seed in enumerate((2**31 + 5, 2**31 + 5, 2**31 + 6)):
        syn = Synthetic(config, seed, "cpu")
        path = tmp_path / f"t{i}.xtc"
        xtcw.write_xtc(str(path), syn.host_frames(), syn.box9, syn.precision, syn.dt_ps,
                       threads=3)
        blobs.append(path.read_bytes())
    assert blobs[0] == blobs[1]
    assert blobs[0] != blobs[2]
    a, b = _grid(config, 2**31 + 5)[1], _grid(config, 2**31 + 6)[1]
    assert a.shape == b.shape and (a != b).mean() > 0.9


def test_seeds_streams_and_prefix():
    _, config, _ = tiny("main-dodec-streamed")
    assert seed_of(2**40 + 3, 0) != seed_of(2**40 + 3, 1)
    assert 0 <= seed_of(2**64 + 9, 0) < 2**63
    _, long = _grid(config, 77, frames=8)
    _, short = _grid(config, 77, frames=5)
    np.testing.assert_array_equal(long[:5], short)


def test_grid_in_box_and_layout():
    _, config, _ = tiny("observables-streamed")
    syn, grid = _grid(config, 3)
    lq = int(round(6.0 * syn.precision))
    assert grid.min() >= 0 and grid.max() < lq
    # a frame moves atoms by a common N(0, 0.05 nm) drift and a per-atom
    # N(0, 0.01 nm) step: tens of grid points
    step = np.abs(grid[1].astype(np.int64) - grid[0])
    step = np.minimum(step, lq - step)
    assert 1 <= np.median(step) <= 150
    st = syn.state("full")
    assert st["positions"].dtype == np.float32 and st["mass"].min() >= 1.0
    assert abs(float(st["charge"].astype(np.float64).sum())) < 1e-3 * syn.n


def test_written_xtc_reads_back_as_the_grid(tmp_path):
    """The frozen writer's file, decoded by the port's codec, is the grid."""
    from groan_rs_tpu_torch.io import native

    for name in ("main-resident", "main-dodec-streamed"):
        _, config, _ = tiny(name)
        syn, grid = _grid(config, 12345)
        path = str(tmp_path / f"{name}.xtc")
        xtcw.write_xtc(path, syn.host_frames(), syn.box9, syn.precision, syn.dt_ps)
        offs, steps, times, nat = native.xtc_scan(path)
        assert nat == syn.n and len(offs) == grid.shape[0]
        coords, boxes, *_ = native.xtc_read_frames(path, offs, nat)
        np.testing.assert_array_equal(np.rint(coords.astype(np.float64) * 1000), grid)
        np.testing.assert_array_equal(boxes[0], syn.box9)
        np.testing.assert_allclose(times, np.arange(grid.shape[0]) * syn.dt_ps)


def test_positions_are_exact_on_the_grid():
    _, config, _ = tiny("main-resident")
    syn = Synthetic(config, 9, "cpu")
    q = syn.grid_frame0()
    x = syn.positions(q)
    assert x.dtype == torch.float64
    assert torch.equal(torch.round(x * 1000).to(torch.int32), q)
