"""Parity of the pair reductions: the port's K3 plain twin against the JAX
Pallas pair kernel (interpret mode on the CPU), and the routed
`ops.distances.min_distance` / `contact_count` of both packages.  Min
distances within 1e-6, counts exact.  Small inputs do not reach the
2^24-pair threshold, so the routed tests lower it to 1 in BOTH packages,
as test_pallas_kernels.py:121 does."""

import numpy as np
import pytest

from groan_rs_tpu.ops import distances as jdist
from groan_rs_tpu.ops import pallas_kernels as pk

from _torch_parity import n, t
from groan_rs_tpu_torch import testing
from groan_rs_tpu_torch.ops import distances as tdist
from groan_rs_tpu_torch.ops import kernels as K


@pytest.fixture(scope="module")
def sets():
    rng = np.random.default_rng(0)
    box = np.array([5.0, 6.0, 7.0], np.float32)
    a = (rng.random((300, 3)) * box).astype(np.float32)
    b = (rng.random((500, 3)) * box).astype(np.float32)
    return a, b, box


def _twin(a, b, box, cutoff):
    d, c = K.pair_reduce_plain(t(a)[None], t(b)[None], t(box)[None], cutoff)
    return float(d[0]), int(c[0])


@pytest.mark.parametrize("cutoff", [0.2, 0.5, 1.0])
def test_k3_twin_matches_pallas(sets, cutoff):
    a, b, box = sets
    d, c = _twin(a, b, box, cutoff)
    assert d == pytest.approx(float(pk.min_distance(a, b, box)), abs=1e-6)
    assert c == int(pk.contact_count(a, b, box, cutoff))


def test_k3_twin_ragged_sizes(sets):
    """257 x 129: neither set a multiple of the TPU's 256 tile."""
    _, _, box = sets
    rng = np.random.default_rng(3)
    a = (rng.random((257, 3)) * box).astype(np.float32)
    b = (rng.random((129, 3)) * box).astype(np.float32)
    d, c = _twin(a, b, box, 0.7)
    assert d == pytest.approx(float(pk.min_distance(a, b, box)), abs=1e-6)
    assert c == int(pk.contact_count(a, b, box, 0.7))


def test_k3_twin_pair_across_boundary(sets):
    _, _, box = sets
    a = np.array([[0.05, 0.05, 0.05]], np.float32)
    b = np.array([[4.95, 5.95, 6.95]], np.float32)
    d, c = _twin(a, b, box, 0.2)
    assert d == pytest.approx(float(pk.min_distance(a, b, box)), abs=1e-6)
    assert d == pytest.approx(np.sqrt(3 * 0.1 ** 2), abs=1e-5)
    assert c == int(pk.contact_count(a, b, box, 0.2)) == 1


def test_k3_twin_chunking_is_invisible(sets):
    """The twin's chunking over a's atoms changes nothing."""
    a, b, box = sets
    whole = K.pair_reduce_plain(t(a)[None], t(b)[None], t(box)[None], 0.6)
    tiny = K.pair_reduce_plain(t(a)[None], t(b)[None], t(box)[None], 0.6,
                               chunk_pairs=700)
    assert float(whole[0][0]) == float(tiny[0][0])
    assert int(whole[1][0]) == int(tiny[1][0])


def test_k3_wrapper_single_frame(sets):
    a, b, box = sets
    d, c = K.pair_reduce(t(a), t(b), t(box), 0.5)
    assert d.dim() == 0 and c.dtype == K.torch.int64
    assert (float(d), int(c)) == _twin(a, b, box, 0.5)


def _batched():
    rng = np.random.default_rng(21)
    B, N, M = 2, 321, 517
    box = rng.uniform(4.0, 6.0, size=(B, 3)).astype(np.float32)
    a = rng.uniform(0, 4, (B, N, 3)).astype(np.float32)
    b = rng.uniform(0, 4, (B, M, 3)).astype(np.float32)
    return a, b, box


def test_dense_branch_matches_jax():
    a, b, box = _batched()
    got = n(tdist.min_distance(t(a), t(b), t(box)[:, None, :]))
    want = n(jdist.min_distance(a, b, box[:, None, :]))
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, atol=1e-6)
    got_c = n(tdist.contact_count(t(a), t(b), t(box)[:, None, :], 0.6))
    assert np.array_equal(got_c, n(jdist.contact_count(a, b, box[:, None, :], 0.6)))
    np.testing.assert_allclose(n(tdist.distance_matrix(t(a), t(b), t(box))),
                               n(jdist.distance_matrix(a, b, box)), atol=1e-6)


def test_routed_branch_matches_jax(monkeypatch):
    """Both packages route to their pair kernel (threshold 1) and agree."""
    monkeypatch.setattr(jdist, "_PAIR_TILE_THRESHOLD", 1)
    monkeypatch.setattr(tdist, "_PAIR_TILE_THRESHOLD", 1)
    a, b, box = _batched()
    calls = []
    real = K.pair_reduce
    monkeypatch.setattr(K, "pair_reduce",
                        lambda *x, **k: calls.append(1) or real(*x, **k))
    got = n(tdist.min_distance(t(a), t(b), t(box)[:, None, :]))
    want = n(jdist.min_distance(a, b, box[:, None, :]))
    np.testing.assert_allclose(got, want, atol=1e-6)
    got_c = n(tdist.contact_count(t(a), t(b), t(box)[:, None, :], 0.6))
    want_c = n(jdist.contact_count(a, b, box[:, None, :], 0.6))
    assert np.array_equal(got_c, want_c)
    assert len(calls) == 2


def test_masked_calls_stay_dense(monkeypatch):
    """Masks keep a call on the dense path even above the threshold."""
    monkeypatch.setattr(jdist, "_PAIR_TILE_THRESHOLD", 1)
    monkeypatch.setattr(tdist, "_PAIR_TILE_THRESHOLD", 1)

    def boom(*_a, **_k):
        raise AssertionError("a masked call reached the pair kernel")

    monkeypatch.setattr(K, "pair_reduce", boom)
    a, b, box = _batched()
    rng = np.random.default_rng(4)
    ma = rng.random(a.shape[:2]) > 0.2
    mb = rng.random(b.shape[:2]) > 0.2
    got = n(tdist.min_distance(t(a), t(b), t(box)[:, None, :], t(ma), t(mb)))
    want = n(jdist.min_distance(a, b, box[:, None, :], ma, mb))
    np.testing.assert_allclose(got, want, atol=1e-6)
    got_c = n(tdist.contact_count(t(a), t(b), t(box)[:, None, :], 0.6, t(ma), t(mb)))
    want_c = n(jdist.contact_count(a, b, box[:, None, :], 0.6, ma, mb))
    assert np.array_equal(got_c, want_c)


def test_same_route_rule():
    assert tdist._PAIR_TILE_THRESHOLD == jdist._PAIR_TILE_THRESHOLD
    a = t(np.zeros((1, 4096, 3), np.float32))
    b = t(np.zeros((1, 4096, 3), np.float32))
    assert tdist._tiled_route(a, b, None, None) == jdist._tiled_route(
        n(a), n(b), None, None)


@pytest.mark.parametrize("cut", ["zero", "half", "half-ulp", "half+ulp"])
@pytest.mark.parametrize("L", [5.0, 20.5, 7.3])
@pytest.mark.parametrize("n_axes", [1, 2, 3])
def test_k3_twin_ties_match_pallas(n_axes, L, cut):
    """Half-box separations: the twin rounds ties as the JAX kernel does
    (min within 1e-6, counts exact at the cutoffs L/2 and L/2 +- 1 ulp)."""
    a, b, box, half = testing.half_box_sets(n_axes, L)
    if L != 7.3:  # dyadic: every tie pair is exactly (k + 1/2) L apart
        gap = np.mod(a[:64] - b, box)[:, :n_axes]
        assert (gap == half).all()
    cutoff = {"zero": np.float32(0.0), "half": half,
              "half-ulp": np.nextafter(half, np.float32(0)),
              "half+ulp": np.nextafter(half, np.float32(np.inf))}[cut]
    d, c = _twin(a, b, box, float(cutoff))
    assert d == pytest.approx(float(pk.min_distance(a, b, box)), abs=1e-6)
    assert c == int(pk.contact_count(a, b, box, float(cutoff)))
