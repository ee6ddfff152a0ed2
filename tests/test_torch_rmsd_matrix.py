"""The matrix analyses of the PyTorch port's `models/structure.py`
(rmsd_matrix, cluster, mdmat, clustsize) and their ops
(`ops.rmsd.rmsd_matrix`, `ops.distances.residue_min_matrix`) against
groan_rs_tpu's on the same input, on the CPU: the 3,000-atom named
synthetic layout, 12 frames, in the 21 nm cube and in the rhombic
dodecahedron.

Tolerances: RMSD and distances 1e-5 nm; the RMSD matrix symmetric within
1e-6 with a zero diagonal (the JAX docstring's claims, the bounds of the
JAX package's own test); cluster labels, centres and sizes exact given the
same matrix; clustsize labels exact on every frame where no entity pair's
smallest distance lies within 1e-5 nm of the cutoff (the frames counted).
Errors raise the JAX package's class and code."""

import numpy as np
import pytest
import torch

from groan_rs_tpu import models as J
from groan_rs_tpu.ops import distances as jdist
from groan_rs_tpu.ops import rmsd as jrmsd

from _torch_parity import named_pairs, raised
from groan_rs_tpu_torch import models as T
from groan_rs_tpu_torch.ops import distances as tdist
from groan_rs_tpu_torch.ops import rmsd as trmsd

FORMS = ("ortho", "triclinic")


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return named_pairs(tmp_path_factory)


@pytest.mark.parametrize("form", FORMS)
def test_rmsd_matrix(pairs, form):
    xtc, js, ts = pairs[form]
    ji, jm = J.rmsd_matrix(js, xtc, "Protein", chunk=5)
    ti, tm = T.rmsd_matrix(ts, xtc, "Protein", chunk=5)
    assert np.array_equal(ji, ti) and tm.shape == (12, 12)
    assert np.abs(tm - jm).max() <= 1e-5
    assert np.abs(tm - tm.T).max() <= 1e-6
    assert np.abs(np.diag(tm)).max() < 1e-5


@pytest.mark.parametrize("chunk", [1, 5, 12, 40])
def test_rmsd_matrix_op_chunks(chunk):
    rng = np.random.default_rng(4)
    frames = rng.uniform(0, 4, (9, 50, 3)).astype(np.float32)
    boxes = np.tile(np.float32([4.0, 4.5, 5.0]), (9, 1))
    w = rng.uniform(1, 16, 50).astype(np.float32)
    want = np.asarray(jrmsd.rmsd_matrix(frames, boxes, w, chunk=3))
    got = trmsd.rmsd_matrix(torch.from_numpy(frames), torch.from_numpy(boxes),
                            torch.from_numpy(w), chunk=chunk).numpy()
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("method,quantile", [("gromos", 0.5), ("linkage", 0.1),
                                             ("jarvis-patrick", 0.5)])
def test_cluster_same_matrix(pairs, method, quantile):
    xtc, js, ts = pairs["ortho"]
    _, m = J.rmsd_matrix(js, xtc, "Protein")
    cut = float(np.quantile(m[np.triu_indices(12, 1)], quantile))
    a = J.cluster(js, matrix=m, cutoff=cut, method=method, jp_m=3, jp_p=1)
    b = T.cluster(ts, matrix=m, cutoff=cut, method=method, jp_m=3, jp_p=1)
    assert len(b["sizes"]) > 1
    for key in ("labels", "centers", "sizes"):
        assert np.array_equal(a[key], b[key]), key


def test_cluster_from_trajectory(pairs):
    xtc, js, ts = pairs["triclinic"]
    b = T.cluster(ts, xtc, "Protein", cutoff=0.05)
    _, m = T.rmsd_matrix(ts, xtc, "Protein")
    assert np.array_equal(b["matrix"], m)
    a = J.cluster(js, matrix=m, cutoff=0.05)
    assert np.array_equal(a["labels"], b["labels"])


@pytest.mark.parametrize("form", FORMS)
def test_mdmat(pairs, form):
    xtc, js, ts = pairs[form]
    a = J.mdmat(js, xtc, "Protein", per_frame=True, chunk=8)
    b = T.mdmat(ts, xtc, "Protein", per_frame=True, chunk=7)
    assert np.array_equal(a["resids"], b["resids"])
    assert np.array_equal(a["resnames"], b["resnames"]) and b["resnames"][0] == "ALA"
    assert b["frames"].shape == (12, 30, 30)
    assert np.abs(b["frames"] - a["frames"]).max() <= 1e-5
    assert np.abs(b["mean"] - a["mean"]).max() <= 1e-5


def test_residue_min_matrix_frame_blocks(monkeypatch):
    """Frames go through the tile in blocks; the blocks do not change the
    result."""
    rng = np.random.default_rng(9)
    pos = rng.uniform(0, 3, (5, 40, 3)).astype(np.float32)
    boxes = np.tile(np.float32([3.0, 3.0, 3.5]), (5, 1))
    idx = np.arange(40).reshape(10, 4)
    mask = np.ones((10, 4), bool)
    mask[3, 2:] = False
    want = np.asarray(jdist.residue_min_matrix(pos, boxes, idx, mask, chunk=4))
    for elems in (1, 10**9):
        monkeypatch.setattr(tdist, "_TILE_ELEMS", elems)
        got = tdist.residue_min_matrix(torch.from_numpy(pos), torch.from_numpy(boxes),
                                       idx, mask, chunk=3).numpy()
        assert np.abs(got - want).max() <= 1e-5



@pytest.mark.parametrize("form", FORMS)
def test_residue_min_matrix_tile_bound(monkeypatch, form):
    """A tile bound smaller than one row of `[R, P, P, 3]` splits the
    column residues too: no displacement tile passes the bound, and the
    values equal those of the unsplit call bit for bit."""
    rng = np.random.default_rng(4)
    pos = torch.from_numpy(rng.uniform(0, 3, (3, 40, 3)).astype(np.float32))
    if form == "ortho":
        boxes = torch.from_numpy(np.tile(np.float32([3.0, 3.0, 3.5]), (3, 1)))
    else:
        h = np.float32([[3.0, 0, 0], [1.0, 2.9, 0], [0.8, 0.6, 3.2]])
        boxes = torch.from_numpy(np.tile(h, (3, 1, 1)))
    idx = np.arange(40).reshape(10, 4)
    mask = np.ones((10, 4), bool)
    mask[6, 1:] = False
    want = tdist.residue_min_matrix(pos, boxes, idx, mask).numpy()
    tiles = []
    wrapped = tdist.min_image if form == "ortho" else tdist.min_image_norm2_frames
    name = "min_image" if form == "ortho" else "min_image_norm2_frames"

    def spy(d, *args):
        tiles.append(d.numel())
        return wrapped(d, *args)

    monkeypatch.setattr(tdist, name, spy)
    bound = 2 * 4 * 4 * 3        # two residue pairs; one row is ten
    monkeypatch.setattr(tdist, "_TILE_ELEMS", bound)
    got = tdist.residue_min_matrix(pos, boxes, idx, mask, chunk=4).numpy()
    assert tiles and max(tiles) <= bound
    assert np.array_equal(got, want)

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mode", ["molecule", "atom"])
def test_clustsize(pairs, form, mode):
    xtc, js, ts = pairs[form]
    group = "Water" if mode == "molecule" else "CA"
    cutoff = 0.35 if mode == "molecule" else 0.9
    a = J.clustsize(js, xtc, group, cutoff=cutoff, mode=mode)
    b = T.clustsize(ts, xtc, group, cutoff=cutoff, mode=mode)
    assert a["n_entities"] == b["n_entities"]
    # frames with an entity pair within 1e-5 nm of the cutoff may differ
    from groan_rs_tpu.models.pipeline import _resident_group_pos

    _, pos, boxes, _ = _resident_group_pos(js, xtc, group, 32)
    blocks = ([[i] for i in range(pos.shape[1])] if mode == "atom" else
              [list(range(3 * i, min(3 * i + 3, pos.shape[1])))
               for i in range(-(-pos.shape[1] // 3))])
    idx = np.zeros((len(blocks), max(map(len, blocks))), np.int32)
    mask = np.zeros(idx.shape, bool)
    for i, bl in enumerate(blocks):
        idx[i, :len(bl)] = bl
        mask[i, :len(bl)] = True
    d = np.asarray(jdist.residue_min_matrix(pos, boxes, idx, mask))
    clean = ~(np.abs(d - cutoff) < 1e-5).any((1, 2))
    assert clean.sum() >= 10
    assert np.array_equal(a["labels"][clean], b["labels"][clean])
    if clean.all():
        for key in ("n_clusters", "max_size", "size_hist"):
            assert np.array_equal(a[key], b[key]), key
        assert np.allclose(a["mean_size_w"], b["mean_size_w"], rtol=1e-12)
    assert np.array_equal(a["times"], b["times"])


ERRORS = {
    "bad method": lambda M, s, x, m: M.cluster(s, matrix=m, method="kmeans"),
    "jp_m": lambda M, s, x, m: M.cluster(s, matrix=m, method="jarvis-patrick", jp_m=12),
    "not square": lambda M, s, x, m: M.cluster(s, matrix=m[:, :5]),
    "no input": lambda M, s, x, m: M.cluster(s),
    "clustsize mode": lambda M, s, x, m: M.clustsize(s, x, "Water", mode="residue"),
    "mdmat empty": lambda M, s, x, m: M.mdmat(s, x, "Protein and name XYZ"),
    "rmsd_matrix group": lambda M, s, x, m: M.rmsd_matrix(s, x, "Nowhere"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_match_jax(pairs, case):
    xtc, js, ts = pairs["ortho"]
    m = np.zeros((12, 12), np.float32)
    want = raised(lambda: ERRORS[case](J, js, xtc, m))
    assert want is not None
    assert raised(lambda: ERRORS[case](T, ts, xtc, m)) == want


@pytest.mark.parametrize("seed", range(3))
def test_host_oracles(seed):
    """The float64 oracles of `chip_smoke.py` phase 13: the cluster labels
    of `testing.host_clusters` equal the JAX package's on random matrices,
    and `testing.host_prepared` + `host_kabsch` and `host_residue_min` agree
    with the JAX functions within 1e-5 nm."""
    from groan_rs_tpu_torch import testing

    rng = np.random.default_rng(seed)
    f = 14
    x = rng.uniform(0, 1, (f, f))
    m = (x + x.T) / 2
    np.fill_diagonal(m, 0)
    for method, kw in (("gromos", {}), ("linkage", {}), ("jarvis-patrick", {"jp_m": 3, "jp_p": 1}),
                       ("jarvis-patrick", {"jp_m": 4, "jp_p": 3})):
        assert np.array_equal(testing.host_clusters(m, method, 0.3, **kw),
                              J.cluster(None, matrix=m, cutoff=0.3, method=method, **kw)["labels"])
    frames = rng.uniform(0, 4, (3, 60, 3)).astype(np.float32)
    box = np.float32([4.0, 4.5, 5.0])
    w = rng.uniform(1, 16, 60).astype(np.float32)
    want = np.asarray(jrmsd.rmsd_matrix(frames, np.tile(box, (3, 1)), w, chunk=3))
    (pa, _, _), (pb, _, _) = (testing.host_prepared(frames[k], box, w) for k in (0, 2))
    assert abs(testing.host_kabsch(pa, pb, w)[0] - want[0, 2]) <= 1e-5
    blocks = [np.arange(k, k + 3) for k in range(0, 60, 3)] + [np.array([59])]
    idx = np.zeros((len(blocks), 3), np.int32)
    mask = np.zeros(idx.shape, bool)
    for i, b in enumerate(blocks):
        idx[i, :len(b)], mask[i, :len(b)] = b, True
    want = np.asarray(jdist.residue_min_matrix(frames, np.tile(box, (3, 1)), idx, mask))[1]
    assert np.abs(testing.host_residue_min(frames[1], box, blocks) - want).max() <= 1e-5
    assert np.abs(testing.host_residue_min(frames[1], box, blocks, rows=blocks[3:5])
                  - want[3:5]).max() <= 1e-5
