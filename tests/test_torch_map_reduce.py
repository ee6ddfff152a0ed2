"""`traj_iter_map_reduce` of the PyTorch port against the JAX package's, on
the 3,000-atom synthetic system and its 12-frame XTC, on the CPU (the
port on one device; the JAX engine on its 8-device CPU mesh, progress
counted as one shard).

The body takes the Protein's refined centre (K1 + K2's twins here) and
the Peptide-Membrane minimum distance (K3's twin, the pair threshold
lowered to 1 in both packages); the fold sums centres and keeps the
smallest distance on the device.  Centres within 2e-4, distances 1e-5,
counts exact; the progress printer's output equals the JAX one's
character for character; a failing body sets FAILED and raises
ParallelError naming its frames; a checkpointed pass stopped by a failing
body resumes to the uninterrupted result; a list of files and `group=`
read what the single file and the full read do."""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from groan_rs_tpu.errors import ParallelError as JParallelError
from groan_rs_tpu.ops import center as jcenter
from groan_rs_tpu.ops import distances as jdist
from groan_rs_tpu.parallel import traj_iter_map_reduce as jmr
from groan_rs_tpu.progress import ProgressPrinter as JPrinter

from _torch_parity import synthetic_pair
from groan_rs_tpu_torch.errors import ParallelError
from groan_rs_tpu_torch.io import native
from groan_rs_tpu_torch.ops import center as tcenter
from groan_rs_tpu_torch.ops import distances as tdist
from groan_rs_tpu_torch.ops import kernels as K
from groan_rs_tpu_torch.parallel import traj_iter_map_reduce as tmr
from groan_rs_tpu_torch.progress import ProgressPrinter as TPrinter

N_FRAMES = 12


@pytest.fixture(scope="module")
def triple(tmp_path_factory):
    return synthetic_pair(tmp_path_factory.mktemp("mr") / "synthetic.xtc", n_frames=N_FRAMES)


@pytest.fixture(autouse=True)
def pair_kernels(monkeypatch):
    monkeypatch.setattr(jdist, "_PAIR_TILE_THRESHOLD", 1)
    monkeypatch.setattr(tdist, "_PAIR_TILE_THRESHOLD", 1)


def _ranges(s):
    def rng(name):
        idx = s.group_indices(name)
        return int(idx[0]), int(idx[-1]) + 1
    return rng("Protein"), rng("Peptide"), rng("Membrane")


def jax_body(s):
    (p0, p1), (q0, q1), (m0, m1) = _ranges(s)

    def body(pos, boxes, mask):
        return {"com": jcenter.center(pos[:, p0:p1], boxes[:, None, :]),
                "mind": jdist.min_distance(pos[:, q0:q1], pos[:, m0:m1], boxes)}
    return body


def port_body(s, fail_at=None):
    (p0, p1), (q0, q1), (m0, m1) = _ranges(s)
    calls = {"n": 0}

    def body(pos, boxes, mask):
        calls["n"] += 1
        if calls["n"] == fail_at:
            raise RuntimeError("boom")
        return {"com": tcenter.center(pos[:, p0:p1], boxes[:, None, :]),
                "mind": tdist.min_distance(pos[:, q0:q1], pos[:, m0:m1], boxes)}
    return body


def jax_fold(carry, out, mask):
    m = mask.astype(jnp.float32)
    return {"sum": carry["sum"] + jnp.sum(out["com"] * m[:, None], axis=0),
            "min": jnp.minimum(carry["min"], jnp.min(jnp.where(mask, out["mind"], jnp.inf))),
            "n": carry["n"] + jnp.sum(mask.astype(jnp.int32))}


def port_fold(carry, out, mask):
    m = mask.to(torch.float32)
    return {"sum": carry["sum"] + (out["com"] * m[:, None]).sum(0),
            "min": torch.minimum(carry["min"],
                                 torch.where(mask, out["mind"], torch.inf).min()),
            "n": carry["n"] + mask.sum().to(torch.int32)}


def jax_init():
    return {"sum": jnp.zeros(3, jnp.float32), "min": jnp.float32(jnp.inf),
            "n": jnp.int32(0)}


def port_init():
    return {"sum": torch.zeros(3), "min": torch.tensor(float("inf")),
            "n": torch.tensor(0, dtype=torch.int32)}


def _host(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _same_carry(got, want):
    np.testing.assert_allclose(got["sum"], want["sum"], rtol=0, atol=N_FRAMES * 2e-4)
    np.testing.assert_allclose(got["min"], want["min"], rtol=0, atol=1e-5)
    assert int(got["n"]) == int(want["n"]) == N_FRAMES


@pytest.mark.parametrize("batch_size", [4, 5])
def test_fold_collect_reduce_match_jax(triple, batch_size):
    xtc, js, ts = triple
    jres, jcol = jmr(js, xtc, jax_body(js), init=jax_init(), fold=jax_fold,
                     batch_size=batch_size, collect=True, reduce=_host)
    K.reset_launch_counts()
    tres, tcol = tmr(ts, xtc, port_body(ts), init=port_init(), fold=port_fold,
                     batch_size=batch_size, collect=True, reduce=_host)
    assert all(v == 0 for v in K.launch_counts.values())
    _same_carry(tres, jres)
    assert tcol["com"].shape == (N_FRAMES, 3) and tcol["mind"].shape == (N_FRAMES,)
    np.testing.assert_allclose(tcol["com"], np.asarray(jcol["com"]), rtol=0, atol=2e-4)
    np.testing.assert_allclose(tcol["mind"], np.asarray(jcol["mind"]), rtol=0, atol=1e-5)
    # fold without collect: the reduced carry alone; no fold: the frames
    assert set(tmr(ts, xtc, port_body(ts), init=port_init(), fold=port_fold,
                   batch_size=batch_size, reduce=_host)) == {"sum", "min", "n"}
    frames = tmr(ts, xtc, port_body(ts), batch_size=batch_size,
                 reduce=lambda out: out["mind"].min())
    np.testing.assert_allclose(frames, tcol["mind"].min(), rtol=0, atol=0)


def _printer(cls, buf):
    return cls().with_print_freq(1).with_output(buf).with_colored(False).with_terminating("\n")


@pytest.mark.parametrize("opts", [{}, {"start_time": 20.0, "end_time": 90.0, "step": 2}])
def test_progress_lines_match_jax(triple, opts):
    xtc, js, ts = triple
    jbuf, tbuf = io.StringIO(), io.StringIO()
    jmr(js, xtc, jax_body(js), batch_size=3, progress=_printer(JPrinter, jbuf),
        progress_shards=1, **opts)
    tmr(ts, xtc, port_body(ts), batch_size=3, progress=_printer(TPrinter, tbuf), **opts)
    assert tbuf.getvalue() == jbuf.getvalue()
    assert tbuf.getvalue().count("COMPLETED") == 2


def test_failing_body_sets_failed(triple):
    xtc, js, ts = triple
    for s, mr, body, err, cls in ((js, jmr, lambda *a: 1 / 0, JParallelError, JPrinter),
                                  (ts, tmr, port_body(ts, fail_at=1), ParallelError,
                                   TPrinter)):
        buf = io.StringIO()
        with pytest.raises(err, match="frames 0..3"):
            mr(s, xtc, body, batch_size=4, progress=_printer(cls, buf))
        assert "FAILED" in buf.getvalue()


def test_checkpoint_resumes_to_the_same_result(triple, tmp_path):
    xtc, js, ts = triple
    want = tmr(ts, xtc, port_body(ts), init=port_init(), fold=port_fold, batch_size=4,
               reduce=_host)
    ckpt = tmp_path / "pass.npz"
    with pytest.raises(ParallelError, match="frames 8..11"):
        tmr(ts, xtc, port_body(ts, fail_at=3), init=port_init(), fold=port_fold,
            batch_size=4, checkpoint=ckpt)
    saved = np.load(ckpt)
    assert int(saved["__cursor__"]) == 8  # the two completed batches
    got = tmr(ts, xtc, port_body(ts), init=port_init(), fold=port_fold, batch_size=4,
              reduce=_host, checkpoint=ckpt)
    assert {k: v.tolist() for k, v in got.items()} == {k: v.tolist() for k, v in want.items()}
    jwant = jmr(js, xtc, jax_body(js), init=jax_init(), fold=jax_fold, batch_size=4,
                reduce=_host)
    _same_carry(got, jwant)
    with pytest.raises(ParallelError, match="fold"):
        tmr(ts, xtc, port_body(ts), batch_size=4, checkpoint=tmp_path / "x.npz")


def test_file_list_and_group_read_the_same(triple, tmp_path):
    xtc, _, ts = triple
    offs, steps, times, nat = native.xtc_scan(xtc)
    coords, b9, _, _, prec = native.xtc_read_frames(xtc, offs, nat)
    parts = [tmp_path / "a.xtc", tmp_path / "b.xtc"]
    for f in range(N_FRAMES):  # frame 6 in both files: dropped once
        for p in ([parts[0]] if f <= 6 else []) + ([parts[1]] if f >= 6 else []):
            native.xtc_write_frame(p, nat, int(steps[f]), float(times[f]), b9[f],
                                   coords[f], float(prec[f]))
    one = tmr(ts, xtc, port_body(ts), batch_size=5)
    cat = tmr(ts, [str(p) for p in parts], port_body(ts), batch_size=5)
    for k in one:
        assert np.array_equal(cat[k], one[k])
    m0, m1 = _ranges(ts)[2]

    def group_body(pos, boxes, mask):
        return {"mean": pos.mean(1)}

    def full_body(pos, boxes, mask):
        return {"mean": pos[:, m0:m1].mean(1)}

    grp = tmr(ts, [xtc], group_body, group="Membrane", start_time=30.0, step=2)
    full = tmr(ts, [xtc], full_body, start_time=30.0, step=2)
    assert grp["mean"].shape == (5, 3) and np.array_equal(grp["mean"], full["mean"])


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"progress_shards": 2}])
def test_multi_device_options_raise(triple, kw):
    xtc, _, ts = triple
    with pytest.raises(ParallelError, match="ROADMAP"):
        tmr(ts, xtc, port_body(ts), **kw)
