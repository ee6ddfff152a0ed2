"""Trajectory writers and the multi-frame GRO reader of the PyTorch port
against the JAX package, on the 3,000-atom synthetic system and frames of
its XTC, on the CPU.

- XTC, TRR, GRO and extended-XYZ files written frame by frame through the
  System's writer registry (all atoms and a group) are byte-identical to
  the JAX writers' on the same frames (the same codec and formatters);
  an XTC reads back within half of 1/precision, a TRR bit for bit.
- `GroSource` / `gro_iter` on a multi-frame GRO written here (velocities
  on some frames, a title without time and step) equal the JAX source and
  iterator field by field.
- The registry's error codes equal; TNG raises `FileTypeError` naming
  ROADMAP.md."""

import os

import numpy as np
import pytest

from groan_rs_tpu.core.topology import StrColumn as JStrColumn
from groan_rs_tpu.errors import GroanError as JGroanError
from groan_rs_tpu.io.traj import GroSource as JGroSource

from _torch_parity import synthetic_pair
from groan_rs_tpu_torch import testing
from groan_rs_tpu_torch.errors import FileTypeError, GroanError
from groan_rs_tpu_torch.io import native
from groan_rs_tpu_torch.io.traj import GroSource as TGroSource

N_FRAMES = 6


@pytest.fixture(scope="module")
def triple(tmp_path_factory):
    """The synthetic pair with residue and atom names
    (`testing.named_layout`), as structure files carry them."""
    xtc, js, ts = synthetic_pair(tmp_path_factory.mktemp("write") / "synthetic.xtc",
                                 n_frames=N_FRAMES)
    names = testing.named_layout(ts.get_n_atoms())
    for key in ("resname", "atomname"):
        setattr(js.topology, key, JStrColumn(values=names[key]))
        setattr(ts.topology, key, names[key])
    return xtc, js, ts


def _frames(xtc):
    offs, _, _, nat = native.xtc_scan(xtc)
    return native.xtc_read_frames(xtc, offs, nat)


def _set_frame(s, coords, b9, f):
    """Frame f of `coords` with seeded velocities (all atoms but 7 on odd
    frames) and forces (even frames), step, time, lambda and box."""
    rng = np.random.default_rng(f)
    s.positions[:] = coords[f]
    s.velocities[:] = rng.normal(size=coords[f].shape).astype(np.float32)
    s.has_velocity[:] = True
    if f % 2:
        s.has_velocity[7] = False
    s.forces[:] = rng.normal(size=coords[f].shape).astype(np.float32) * 100
    s.has_force[:] = f % 2 == 0
    s.set_step(1000 * f + 3)
    s.set_time(2.5 * f)
    s.set_lambda(0.125 * f)
    s.simbox.v1x, s.simbox.v2y, s.simbox.v3z = map(float, b9[f][[0, 4, 8]])


# (format, group, writer keyword arguments)
WRITES = [("xtc", "all", {}), ("xtc", "Protein", {}), ("trr", "all", {}),
          ("trr", "Membrane", {}), ("gro", "all", {}), ("gro", "Peptide", {}),
          ("gro", "Peptide", {"write_velocities": True}), ("xyz", "all", {}),
          ("xyz", "Water", {})]


@pytest.mark.parametrize("fmt,group,kw", WRITES, ids=[f"{f}-{g}-{bool(k)}" for f, g, k in WRITES])
def test_writers_match_jax_bytes(triple, tmp_path, fmt, group, kw):
    xtc, js0, ts0 = triple
    coords, b9, *_ = _frames(xtc)
    paths = []
    for s0, tag in ((js0, "jax"), (ts0, "port")):
        s = s0.copy()
        path = tmp_path / f"{tag}.{fmt}"
        path.write_text("stale")  # a writer replaces an existing file
        if group == "all":
            s.traj_writer_init(path, **kw)
        else:
            s.group_traj_writer_init(group, path, **kw)
        assert s.get_n_writers() == 1
        for f in range(N_FRAMES):
            _set_frame(s, coords, b9, f)
            s.traj_write_frame()
        s.traj_close()
        assert s.get_n_writers() == 0
        paths.append(path)
    want, got = (p.read_bytes() for p in paths)
    assert got == want and len(got) > 1000


def test_xtc_and_trr_read_back(triple, tmp_path):
    """Through the port's own reader: XTC positions within half of
    1/precision of what was written, TRR positions, velocities and forces
    bit for bit (zeros where an atom or frame had none)."""
    xtc, _, ts0 = triple
    coords, b9, *_ = _frames(xtc)
    s = ts0.copy()
    s.set_precision(1000)
    s.xtc_group_writer_init("Protein", tmp_path / "p.xtc")
    s.trr_writer_init(tmp_path / "a.trr")
    written = []
    for f in range(N_FRAMES):
        _set_frame(s, coords, b9, f)
        s.traj_write_frame()
        written.append((s.positions.copy(), s.velocities.copy(), s.has_velocity.copy(),
                        s.forces.copy(), s.has_force.copy()))
    s.traj_writers_close()
    idx = s.group_indices("Protein")
    for f, frame in enumerate(ts0.group_extract("Protein").xtc_iter(tmp_path / "p.xtc")):
        gap = np.abs(frame.positions - written[f][0][idx]).max()
        assert gap <= 0.5 / 1000 + 1e-6
        assert frame.get_precision() == 1000 and frame.get_step() == 1000 * f + 3
    for f, frame in enumerate(ts0.copy().trr_iter(tmp_path / "a.trr")):
        x, v, hv, fo, hf = written[f]
        assert np.array_equal(frame.positions, x)
        assert np.array_equal(frame.velocities, np.where(hv[:, None], v, 0))
        # the writer always writes all three blocks (trr_io.rs:483-506)
        assert frame.has_velocity.all() and frame.has_forces()
        assert np.array_equal(frame.forces, np.where(hf[:, None], fo, 0))
        assert (frame.get_time(), frame.get_step()) == (2.5 * f, 1000 * f + 3)
    assert f == N_FRAMES - 1


def _multi_gro(path, s, coords, b9):
    """A multi-frame GRO by the port's writer: velocities on frames 1 and 3,
    then one frame whose title carries no time and step, and one whose
    lines mix velocity columns."""
    s.traj_writer_init(path)
    for f in range(4):
        _set_frame(s, coords, b9, f)
        s.has_velocity[:] = f % 2 == 1
        s.traj_write_frame()
    s.traj_close()
    lines = path.read_text().splitlines(keepends=True)
    n = s.get_n_atoms()
    frame = lines[:n + 3]
    frame[0] = "no time here\n"
    mixed = list(lines[n + 3:2 * n + 6])
    mixed[0] = "mixed t= 99.5 step= 42\n"
    for i in range(2, n + 2, 2):
        mixed[i] = mixed[i][:44].rstrip("\n") + "\n"
    path.write_text("".join(lines + frame + mixed))


@pytest.mark.parametrize("batch_size", [1, 4])
def test_gro_source_and_iter_match_jax(triple, tmp_path, batch_size):
    xtc, js0, ts0 = triple
    coords, b9, *_ = _frames(xtc)
    path = tmp_path / "traj.gro"
    _multi_gro(path, ts0.copy(), coords, b9)
    jsrc, tsrc = JGroSource(path), TGroSource(path)
    assert tsrc.n_frames() == jsrc.n_frames() == 6 and tsrc.natoms == jsrc.natoms
    assert np.array_equal(tsrc.times, jsrc.times) and np.array_equal(tsrc.steps, jsrc.steps)
    jb, tb = jsrc.read_batch(np.arange(6)), tsrc.read_batch(np.arange(6))
    for key in ("positions", "velocities", "boxes9", "steps", "times", "has_x", "has_v",
                "has_f", "vel_mask"):
        assert np.array_equal(getattr(tb, key), getattr(jb, key)), key
    js, ts = js0.copy(), ts0.copy()
    pairs = zip(js.gro_iter(path, batch_size=batch_size),
                ts.gro_iter(path, batch_size=batch_size))
    for k, (jf, tf) in enumerate(pairs):
        for key in ("positions", "velocities", "has_velocity", "has_position", "has_force"):
            assert np.array_equal(getattr(tf, key), getattr(jf, key)), (k, key)
        assert (tf.get_time(), tf.get_step()) == (jf.get_time(), jf.get_step())
        assert np.array_equal(tf.get_box().to_matrix(), jf.get_box().to_matrix())
    assert k == 5
    jg = [f.positions[5].copy() for f in js0.copy().gro_iter(path, group="Peptide", step=2)]
    tg = [f.positions[5].copy() for f in ts0.copy().gro_iter(path, group="Peptide", step=2)]
    assert np.array_equal(np.asarray(tg), np.asarray(jg)) and len(tg) == 3


@pytest.mark.parametrize("case", ["WriterAlreadyExists", "WriterNotFound", "GroupNotFound",
                                  "UnknownFormat"])
def test_writer_errors_match_jax(triple, tmp_path, case):
    _, js0, ts0 = triple
    codes = []
    for s, err, tag in ((js0.copy(), JGroanError, "j"), (ts0.copy(), GroanError, "t")):
        p = tmp_path / f"{tag}.xtc"

        def call():
            if case == "WriterAlreadyExists":
                s.traj_writer_init(p)
                s.xtc_writer_init(p)
            elif case == "WriterNotFound":
                s.traj_write_frame_to_file(p)
            elif case == "GroupNotFound":
                s.traj_group_writer_init("Nope", p)
            else:
                s.traj_writer_init(tmp_path / f"{tag}.abc", fmt="abc")

        with pytest.raises(err) as e:
            call()
        codes.append(e.value.code)
    assert codes[0] == codes[1] == case


def test_tng_raises(triple, tmp_path):
    _, _, ts = triple
    for call in (lambda: ts.traj_writer_init(tmp_path / "a.tng"),
                 lambda: ts.tng_iter(tmp_path / "a.tng"),
                 lambda: ts.traj_iter(tmp_path / "a.tng")):
        with pytest.raises(FileTypeError, match="ROADMAP"):
            call()
    assert not os.path.exists(tmp_path / "a.tng")
