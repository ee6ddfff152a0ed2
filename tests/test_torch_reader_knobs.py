"""The reader's environment knobs in the PyTorch port, as the JAX reader
reads them: `GROAN_WIRE` overrides the wire a caller asks for
(`groan_rs_tpu/io/traj.py:639`), and `GROAN_DECODE_THREADS` sets the
native decoder's thread count (`groan_rs_tpu/io/native.py:144-148`).
The port has no delta wire, so `GROAN_WIRE=delta` raises `InvalidWire`.
Frames equal the JAX reader's bit for bit."""

import os

import numpy as np
import pytest

from groan_rs_tpu.io.traj import traj_iter as jtraj_iter

from _torch_parity import jax_system
from groan_rs_tpu_torch import convert, testing
from groan_rs_tpu_torch.errors import ReadTrajError
from groan_rs_tpu_torch.io import native
from groan_rs_tpu_torch.io.traj import traj_iter

N_ATOMS, N_FRAMES = 600, 6


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("knobs") / "k.xtc")
    testing.build_trajectory(path, N_ATOMS, N_FRAMES)
    offs, _, _, nat = native.xtc_scan(path)
    x, b9, *_ = native.xtc_read_frames(path, offs, nat)
    state = testing.synthetic_state(x[0], b9[0][[0, 4, 8]])
    return path, state, x


def _batches(system, path, wire):
    return list(traj_iter(system, path, batch_size=4).batches(wire=wire))


def test_wire_env_overrides_argument(data, monkeypatch):
    path, state, x = data
    tsys = convert.system_from_state(state, device="cpu")
    monkeypatch.setenv("GROAN_WIRE", "q16")
    got = _batches(tsys, path, "f32")
    assert [b.wire for b in got] == ["q16", "q16"]
    assert all(b.positions.dtype == np.int16 for b in got)
    want = list(jtraj_iter(jax_system(state), path, batch_size=4).batches())
    assert [b.wire for b in want] == ["q16", "q16"]
    for g, w in zip(got, want):
        assert np.array_equal(g.positions, w.positions)
    deq = np.concatenate([b.positions.astype(np.float32)
                          * np.float32(1.0 / b.precisions[0]) for b in got])
    assert np.array_equal(deq, x)
    monkeypatch.setenv("GROAN_WIRE", "f32")
    assert all(b.positions.dtype == np.float32 for b in _batches(tsys, path, "q16"))


@pytest.mark.parametrize("wire", ["delta", "delta6", "bogus"])
def test_wire_env_unported_raises(data, monkeypatch, wire):
    path, state, _ = data
    tsys = convert.system_from_state(state, device="cpu")
    monkeypatch.setenv("GROAN_WIRE", wire)
    with pytest.raises(ReadTrajError) as e:
        _batches(tsys, path, "f32")
    assert e.value.code == "InvalidWire"


class _Recorder:
    """The native library with its decoders' last argument (the thread
    count) recorded."""

    def __init__(self, lib):
        self.lib, self.threads = lib, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name not in ("gx_xtc_read", "gx_xtc_read_q16", "gx_trr_read"):
            return fn

        def call(*args):
            self.threads.append(args[-1])
            return fn(*args)

        return call


@pytest.mark.parametrize("env", [None, "1", "3"])
def test_decode_threads_env(data, monkeypatch, env):
    path, state, x = data
    tsys = convert.system_from_state(state, device="cpu")
    rec = _Recorder(native.get_lib())
    monkeypatch.setattr(native, "_lib", rec)
    if env is None:
        monkeypatch.delenv("GROAN_DECODE_THREADS", raising=False)
    else:
        monkeypatch.setenv("GROAN_DECODE_THREADS", env)
    got = np.concatenate([b.positions for b in _batches(tsys, path, "f32")])
    assert np.array_equal(got, x)
    want = native.n_default_threads()
    assert want == (int(env) if env else max(1, os.cpu_count() or 1))
    assert rec.threads and set(rec.threads) == {want}
