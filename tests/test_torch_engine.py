"""Step results never alias the engine's staging buffers.

The streamed pass reuses two staging slots and concatenates the per-batch
results only after the last batch; on the CPU the slot's host buffers are
the step's inputs.  A step that returns `boxes` itself (as
`add_box_lengths` does) must still give every frame its own box after
three or more batches, streamed and resident, with every frame's box
different."""

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (one intra-op thread)
from groan_rs_tpu_torch import convert, testing
from groan_rs_tpu_torch.io import native
from groan_rs_tpu_torch.io.traj import traj_iter
from groan_rs_tpu_torch.models import TrajectoryAnalysis as TTA
from groan_rs_tpu_torch.parallel import FrameEngine

N_ATOMS, N_FRAMES = 60, 7


@pytest.fixture(scope="module")
def npt(tmp_path_factory):
    """An XTC whose box changes every frame (an NPT run)."""
    path = str(tmp_path_factory.mktemp("npt") / "npt.xtc")
    rng = np.random.default_rng(4)
    boxes = (np.asarray([4.0, 4.5, 5.0], np.float32)
             + np.arange(N_FRAMES, dtype=np.float32)[:, None] * np.float32(0.125))
    for f in range(N_FRAMES):
        pos = (rng.uniform(0, 1, (N_ATOMS, 3)) * boxes[f]).astype(np.float32)
        native.xtc_write_frame(path, N_ATOMS, f, f * 2.0,
                               np.diag(boxes[f]).astype(np.float32).reshape(9),
                               pos, 1000.0)
    state = testing.synthetic_state(np.zeros((N_ATOMS, 3), np.float32), boxes[0])
    return path, boxes, convert.system_from_state(state)


@pytest.mark.parametrize("wire", ["f32", "q16"])
def test_step_returning_its_inputs(npt, wire):
    path, boxes, system = npt
    engine = FrameEngine(
        lambda pos, bx, mask: {"boxes": bx, "first": pos[:, 0]}, "cpu")
    out = engine.run(traj_iter(system, path, batch_size=2).batches(wire=wire))
    assert np.array_equal(out["boxes"], boxes)
    offs, _, _, nat = native.xtc_scan(path)
    coords = native.xtc_read_frames(path, offs, nat)[0]
    assert np.array_equal(out["first"], coords[:, 0])


def test_box_lengths_streamed_and_resident(npt):
    path, boxes, system = npt
    runner = TTA(system, device="cpu").add_box_lengths().add_box_volume().runner()
    out = runner.run(path, batch_size=2)
    assert np.array_equal(out["box_lengths"], boxes)
    np.testing.assert_allclose(out["box_volume"], boxes.prod(1), rtol=1e-6)
    dt = runner.load_device(path, batch_size=2)
    for res in (runner.engine.run_resident(dt, batch_size=2),
                runner.engine.run_resident_fused(dt, batch_size=3)):
        assert np.array_equal(res["box_lengths"], boxes)
        assert not np.shares_memory(res["box_lengths"], dt.boxes.numpy())
