#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port's main path (groan_rs_tpu_torch).

    python3 chip_smoke.py            # on a machine with one CUDA card

Phases, each of which raises on failure (the run then exits non-zero):

1. Environment: a CUDA card must be present; prints its name and power
   limit (nvidia-smi), torch and CUDA versions.
2. Build: the CUDA kernels (csrc/*.cu, nvcc for sm_90a) and the native XTC
   codec, from the sources in this checkout.
3. Kernels against their plain PyTorch twins on the card: K1/K2 (refined
   Bai-Breen centre) and K3 (tiled pair reduction) at the main path's
   shapes and at ragged, masked, boundary and empty cases.  K3 bit for bit
   (min bits and counts) at half-box ties (`testing.tie_quotients`,
   `half_box_sets`, `half_box_lattice`), at N < M, N > M and N above the
   staged tile for B = 1 and 100, and over five repeated calls.  K1 within
   1e-4 and K2 within 2e-4 at n = 1..300000 for B = 100, 1, 12 back to
   back (ticket reuse), K2 with and without masked weights; the same bits
   on an unaligned view as on its aligned copy, over five calls and (K2)
   for a frame alone as in its batch; one CUDA launch per K1 and per K2
   call, by the library's own count.  K2 on the refine tie sets
   (`testing.refine_tie_sets`): each tie coordinate alone in a thread
   (`testing.refine_tie_atoms`) unwrapped as the twin does, the 28-atom
   frames within 1e-5.  Times of kernels and
   twins, with and without an L2 flush, beside each kernel's bound.
4. Main path, streamed: a synthetic 1,000,000-atom membrane-protein system
   (protein 99k, membrane 300k atoms) over SMOKE_FRAMES frames (default
   48), COM + COM distance + fitted RMSD + peptide-membrane min distance at
   batch 12 over the q16 wire; checked against float64 host oracles.
5. Device-resident re-run: load_device, then run_resident_fused and
   run_resident, each equal to the streamed pass within 1e-6.  Then, on
   the parity frames, the COM-COG distance of the kernel path against
   the twin path (the port's functions on CPU tensors): within 1e-4 plus
   what atoms changing image between the two membrane estimates explain
   (`testing.center_jump_bound`), and the distance from estimates rounded
   as the twin, the twin without its wrap and the kernel round them.
6. The K1, K2 and K3 launch counters rose during phases 4 and 5.
7. The observables pass at full width: the same XTC over a System with
   the full synthetic topology (charges, bonds, elements), every atom
   shipped (water is touched), batch 12: gyration, density map, mass and
   charge density profiles, peptide-membrane RDF, dipole, box volume and
   lengths, water total dipole, lipid order parameters, water angles,
   lipid dihedrals, principal moments and a cylinder count.  Checked on
   2 frames against the float64 oracles of `testing.py`; the resident
   passes equal the streamed one within 1e-6; `run_many` over the window
   with this pass and phase 4's equals the two `run(dt)` calls bit for
   bit in one packed fetch; the K1 and K2 launch counters rose.
8. The triclinic main path: the synthetic system in an xy-square rhombic
   dodecahedron (d = 23.57 nm, the 21 nm cube's volume; the protein on a
   cell corner, the membrane on the plane z = 0 through it, so the faces
   split both; GROMACS `put_atoms_in_box` wrapping keeps the q16 wire),
   `TrajectoryAnalysis(system, triclinic=True)`: COM, COM distance,
   fitted RMSD, peptide-membrane min distance and contacts (0.4 nm), batch
   12, streamed twice; against the triclinic float64 oracles (COM,
   distance, RMSD within 2e-3 on 24 frames, min distance within 1e-4 and
   contacts inside the oracle's bounds on 2); the resident passes equal
   streamed; the box inverse, the volume and the triclinic centre and pair
   path make no host synchronisation; an orthorhombic treatment of the
   diagonal puts the frame-0 COM more than 1 nm off; K1, K2 and K3 never
   launch.
9. The triclinic observables: the full topology in the same box, every
   atom shipped, 12 frames (one batch): phase 7's observables without the
   in-shape count (which a triclinic pass refuses), the density map over
   an explicit span; the float64 oracles on 2 frames (the RDF on 1);
   resident equal to streamed; `run_many` with phase 8's pass equal to the
   two `run(dt)` calls bit for bit; K1, K2 and K3 never launch.

Every phase prints its seconds.  The last two stdout lines are the
kernels' JSON record and the result line `{"ok": true, "device":
{...}}`.  Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

N_ATOMS = 1_000_000
N_FRAMES = int(os.environ.get("SMOKE_FRAMES", 48))
BATCH = 12
PARITY_FRAMES = min(24, N_FRAMES)


def say(*a):
    print(*a, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)
    say(f"  ok: {what}")


def cuda_ms(fn, reps):
    """Mean device milliseconds per call over `reps` calls (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_events(prof):
    """(name, self device microseconds, count) of the CUDA-side events of a
    profile, largest first."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us and "cuda" in str(getattr(e, "device_type", "")).lower():
            rows.append((e.key, float(us), int(e.count)))
    return sorted(rows, key=lambda r: -r[1])


def device_ms(fn, reps, names=None, flush=None):
    """Device milliseconds per call (torch.profiler) over `reps` calls after
    one warm-up call: the summed device time of what `fn` launches, or with
    `names` of the kernels whose names contain one of them.  With `flush`,
    a 100 MB buffer is read before every call, so the call finds its inputs
    outside the 50 MB L2 (a read leaves the L2 clean: a write would make
    the timed call pay for writing the flush buffer back).  None when the
    profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.sum()
            fn()
        torch.cuda.synchronize()
    total = sum(us for k, us, _ in _device_events(prof)
                if names is None or any(nm in k for nm in names))
    return total / 1e3 / reps if total > 0 else None


def timed(fn, reps, names=None):
    """(device ms per call from the profiler, of `names` as in `device_ms`,
    or from CUDA events when the profiler shows no device time; CUDA-event
    ms per call)."""
    ev = cuda_ms(fn, reps)
    dev = device_ms(fn, reps, names)
    return (dev if dev is not None else ev), ev


def max_err(x, y):
    """Max |x - y|; NaNs must sit at the same places (empty selections)."""
    import torch

    x, y = x.double(), y.double()
    nan = torch.isnan(x)
    if not torch.equal(nan, torch.isnan(y)):
        return float("inf")
    return float((x[~nan] - y[~nan]).abs().max()) if (~nan).any() else 0.0


# Rooflines of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s, and FP32
# instructions/s outside the tensor cores -- the 67 TFLOP/s float32 peak
# counts an FMA as two, and none of these kernels' arithmetic can fuse.
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12 / 2
# K3's least exact work per pair: per axis sub, mul by 1/L, add 0.5,
# round, mul by L, sub, square (21); two adds of the squares; min; compare.
K3_OPS_PER_PAIR = 25
KERNEL_NAMES = {"bai_breen_estimate": ["estimate_kernel"],
                "bai_breen_refine": ["refine_kernel"],
                "pair_reduce": ["pair_reduce_kernel"]}


def bound(nbytes, ops):
    """(least ms for the work, "bytes" or "operations")."""
    t_b, t_o = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def k1_bound(b, n, weighted):
    # read positions (+ weights) and boxes once, write the estimates; per
    # coordinate wrap 4, angle 1, sin and cos 2, weighted sums 4; + sum w
    return bound(b * n * 12 + (n * 4 if weighted else 0) + b * 24,
                 b * n * (3 * 11 + 1))


def k2_bound(b, n, weighted):
    # positions (+ weights), boxes and estimates in, centres out; per
    # coordinate unwrap 8, weighted sum 2; + sum w
    return bound(b * n * 12 + (n * 4 if weighted else 0) + b * 36,
                 b * n * (3 * 10 + 1))


def k3_bound(b, n, m):
    return bound((b * (n + m + 1) * 3) * 4 + b * 12,
                 K3_OPS_PER_PAIR * b * n * m)


def same_bits(x, y):
    import torch

    return x.shape == y.shape and torch.equal(
        x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))


def k3_exact(K, a, b, boxes, cut, what):
    """K3 against its twin: min bits and counts equal."""
    dk, ck = K.pair_reduce(a, b, boxes, cut)
    dp, cp = K.pair_reduce_plain(a, b, boxes, cut)
    if not (same_bits(dk, dp) and bool((ck == cp).all())):
        bad = ((dk.view(-1) != dp.view(-1)) | (ck.view(-1) != cp.view(-1))).nonzero()
        i = int(bad[0]) if len(bad) else 0
        raise AssertionError(
            f"K3 {what}: frame {i} kernel ({float(dk.view(-1)[i])!r}, "
            f"{int(ck.view(-1)[i])}) vs twin ({float(dp.view(-1)[i])!r}, "
            f"{int(cp.view(-1)[i])})")
    return dk, ck


def k3_tie_checks(dev):
    """K3 bit for bit against its twin at and near half-box ties: the tie
    quotients one pair per frame (both staging roles), the half-box sets
    at the cutoffs 0, L/2 and L/2 +- 1 ulp, and half-box lattices."""
    import torch

    from groan_rs_tpu_torch import testing
    from groan_rs_tpu_torch.ops import kernels as K

    f32 = np.float32
    d, lens = testing.tie_quotients()
    n_frames = 0
    for L in testing.TIE_LENGTHS:
        dd = torch.from_numpy(d[lens == f32(L)]).to(dev)
        one = dd[:, None, None].expand(-1, 1, 3).contiguous()   # a - b = (d, d, d)
        zero = torch.zeros_like(one)
        boxes = torch.full((len(dd), 3), float(f32(L)), device=dev)
        cut = float(f32(np.sqrt(3.0) * L / 2))
        k3_exact(K, one, zero, boxes, cut, f"tie quotients L={L} (a staged)")
        k3_exact(K, one.expand(-1, 2, 3).contiguous(), zero, boxes, cut,
                 f"tie quotients L={L} (b staged)")
        n_frames += len(dd)
    check(True, f"K3 tie quotients: {n_frames} one-pair frames, both staging "
          "roles, min bits and counts equal the twin's")
    cases = 0
    for n_axes in (1, 2, 3):
        for L in (5.0, 20.5, 7.3):
            a, b, box, half = testing.half_box_sets(n_axes, L)
            for cut in (f32(0.0), half, np.nextafter(half, f32(0)),
                        np.nextafter(half, f32(np.inf))):
                args = [torch.from_numpy(x).to(dev)[None] for x in (a, b, box)]
                k3_exact(K, *args, float(cut), f"half-box set {n_axes} axes L={L}")
                k3_exact(K, args[1], args[0], args[2], float(cut),
                         f"half-box set {n_axes} axes L={L}, roles swapped")
                cases += 2
    for L in testing.TIE_LENGTHS:
        a, b, box, h = testing.half_box_lattice(L)
        args = [torch.from_numpy(x).to(dev)[None] for x in (a, b, box)]
        k3_exact(K, *args, float(np.nextafter(h, f32(np.inf))), f"lattice L={L}")
        cases += 1
    check(True, f"K3 half-box sets and lattices: {cases} cases bit for bit")


def k3_role_checks(dev, uniform):
    """K3 bit for bit at N < M, N > M and N above the staged tile, at
    B = 1 and 100, and at B = 65535, with boxes whose 1/L is not exact."""
    import torch

    from groan_rs_tpu_torch.ops import kernels as K

    for n, m in ((5000, 300), (300000, 400), (4096, 4096)):
        for b in (1, 100):
            boxes = torch.tensor([[7.3, 20.5, 3.0]], device=dev).expand(b, 3).contiguous()
            a = uniform(b, n, 3, lo=-0.5, hi=1.5) * boxes[:, None, :]
            bb = uniform(b, m, 3, lo=-0.5, hi=1.5) * boxes[:, None, :]
            _, ck = k3_exact(K, a, bb, boxes, 0.5, f"{b} x {n} x {m}")
            check(True, f"K3 B={b} {n} x {m}: min bits and counts equal the "
                  f"twin's ({int(ck.sum())} contacts)")
            del a, bb
            torch.cuda.empty_cache()
    boxes = torch.tensor([[7.3, 20.5, 3.0]], device=dev).expand(65535, 3).contiguous()
    _, ck = k3_exact(K, uniform(65535, 1, 3, lo=-0.5, hi=1.5) * boxes[:, None, :],
                     uniform(65535, 2, 3, lo=-0.5, hi=1.5) * boxes[:, None, :],
                     boxes, 2.0, "65535 frames of 1 x 2")
    check(True, f"K3 B=65535 1 x 2: min bits and counts equal the twin's "
          f"({int(ck.sum())} contacts)")


def k1_checks(dev, uniform):
    """K1 against its twin (1e-4) on clustered frames, at odd sizes, a view
    that starts at an odd atom, B = 1 / 12 / 100 back to back; repeated
    calls and the unaligned view give identical bits; one launch a call."""
    import torch

    from groan_rs_tpu_torch.ops import kernels as K

    def clustered(b, n, box):
        ctr = uniform(b, 1, 3) * box
        return (ctr + torch.randn(b, n, 3, generator=gen).to(dev) * 0.12 * box
                + uniform(b, n, 3, lo=-0.02, hi=0.02) * box)

    gen = torch.Generator().manual_seed(1)
    box = torch.tensor([21.0, 21.0, 20.5], device=dev)
    box12 = box.expand(12, 3).contiguous()
    first = {}
    worst = 0.0
    for n in (1, 2047, 2048, 2049, 99000, 300000):
        for b in (100, 1, 12):  # back to back: the tickets are reused
            boxes = box.expand(b, 3).contiguous()
            pos = clustered(b, n, box)
            w = uniform(n, lo=1.0, hi=16.0)
            w[::7] = 0.0
            for wt in (None, w):
                est = K.bai_breen_estimate(pos, wt, boxes)
                e = max_err(est, K.bai_breen_estimate_plain(pos, wt, boxes))
                worst = max(worst, e)
                if e >= 1e-4:
                    raise AssertionError(f"K1 n={n} B={b}: {e:.3e} from the twin")
                if b == 12 and wt is None:
                    first[n] = (pos, est)
    check(True, f"K1 within 1e-4 of its twin at n = 1..300000, B = 100, 1, 12 "
          f"back to back, with and without weights (max {worst:.2e})")
    for n, (pos, est) in first.items():  # after every other B ran
        check(same_bits(K.bai_breen_estimate(pos, None, box12), est),
              f"K1 n={n}: the same bits after calls at other B")
    pos, est = first[300000]
    check(all(same_bits(K.bai_breen_estimate(pos, None, box12), est)
              for _ in range(5)), "K1 [12, 300000, 3]: five calls, identical bits")
    wide = clustered(12, 300001, box)
    view = wide[:, 1:]  # starts at atom 1: 12 bytes past a 16-byte boundary
    check(view.data_ptr() % 16 != 0, "the slice view is not 16-byte aligned")
    ev = K.bai_breen_estimate(view, None, box12)
    check(same_bits(ev, K.bai_breen_estimate(view.contiguous(), None, box12)),
          "K1 reads the unaligned view in place with the aligned copy's bits")
    e = max_err(ev, K.bai_breen_estimate_plain(view.contiguous(), None, box12))
    check(e < 1e-4, f"K1 unaligned view within 1e-4 of its twin ({e:.2e})")
    lib = K._load()
    for fn, per_call, what in (
            (lambda: K.bai_breen_estimate(pos, None, box12), 1, "K1"),
            (lambda: K.bai_breen_refine(pos, None, box12, est), 1, "K2")):
        n0 = lib.gk_bb_launches()
        for _ in range(3):
            fn()
        made = lib.gk_bb_launches() - n0
        check(made == 3 * per_call, f"{what} makes {per_call} CUDA launch"
              f"{'es' if per_call > 1 else ''} per call (3 calls: {made}, "
              "the library's own count of its <<<>>> launches)")
    return worst


def k2_checks(dev, uniform):
    """K2 against its twin (2e-4) around fixed estimates on clustered
    frames, at odd sizes, B = 100 / 1 / 12 back to back, with and without
    masked weights; repeated calls, calls at other B, each frame alone and
    a view 12 bytes off alignment give the batch's bits: a frame's sums
    depend on N alone."""
    import torch

    from groan_rs_tpu_torch.ops import kernels as K

    gen = torch.Generator().manual_seed(2)
    box = torch.tensor([21.0, 21.0, 20.5], device=dev)
    box12 = box.expand(12, 3).contiguous()

    def clustered(b, n):
        ctr = uniform(b, 1, 3) * box
        return (ctr + torch.randn(b, n, 3, generator=gen).to(dev) * 0.12 * box
                + uniform(b, n, 3, lo=-0.02, hi=0.02) * box)

    first = {}
    worst = 0.0
    for n in (1, 2047, 2048, 2049, 99000, 300000):
        for b in (100, 1, 12):  # back to back: the tickets are reused
            boxes = box.expand(b, 3).contiguous()
            pos = clustered(b, n)
            est = K.bai_breen_estimate_plain(pos, None, boxes)
            w = uniform(n, lo=1.0, hi=16.0)
            w[::7] = 0.0
            for wt in (None, w):
                ctr = K.bai_breen_refine(pos, wt, boxes, est)
                e = max_err(ctr, K.bai_breen_refine_plain(pos, wt, boxes, est))
                worst = max(worst, e)
                if e >= 2e-4:
                    raise AssertionError(f"K2 n={n} B={b} weights={wt is not None}: "
                                         f"{e:.3e} from the twin")
                if b == 12:
                    first[n, wt is not None] = (pos, wt, est, ctr)
    check(True, f"K2 within 2e-4 of its twin at n = 1..300000, B = 100, 1, 12 "
          f"back to back, with and without masked weights (max {worst:.2e})")
    for (n, weighted), (pos, wt, est, ctr) in first.items():  # after every other B
        check(same_bits(K.bai_breen_refine(pos, wt, box12, est), ctr),
              f"K2 n={n} weights={weighted}: the same bits after calls at other B")
        alone = torch.cat([K.bai_breen_refine(pos[f:f + 1], wt, box12[:1], est[f:f + 1])
                           for f in range(12)])
        check(same_bits(alone, ctr), f"K2 n={n} weights={weighted}: each frame "
              "alone (B = 1) gives its bits in the batch of 12")
    pos, _, est, ctr = first[300000, False]
    check(all(same_bits(K.bai_breen_refine(pos, None, box12, est), ctr)
              for _ in range(5)), "K2 [12, 300000, 3]: five calls, identical bits")
    wide = clustered(12, 300001)
    view = wide[:, 1:]  # starts at atom 1: 12 bytes past a 16-byte boundary
    w_wide = uniform(300001, lo=1.0, hi=16.0)
    wv = w_wide[1:]  # 4 bytes past a 16-byte boundary
    check(view.data_ptr() % 16 != 0 and wv.data_ptr() % 16 != 0,
          "the slice views are not 16-byte aligned")
    est = K.bai_breen_estimate_plain(view.contiguous(), None, box12)
    for wt, wc in ((None, None), (wv, wv.clone())):
        ev = K.bai_breen_refine(view, wt, box12, est)
        check(same_bits(ev, K.bai_breen_refine(view.contiguous(), wc, box12, est)),
              f"K2 weights={wt is not None} reads the unaligned views in place "
              "with the aligned copies' bits")
        e = max_err(ev, K.bai_breen_refine_plain(view.contiguous(), wc, box12, est))
        check(e < 2e-4, f"K2 unaligned view within 2e-4 of its twin ({e:.2e})")
    return worst


def k2_tie_checks(dev):
    """K2 against its twin on the refine tie sets, where d = (p - e) + L/2
    is k L or a few steps from it: each tie coordinate alone in one
    thread's frame (`testing.refine_tie_atoms`, whose centre is the
    unwrapped atom) equal to the twin, and the 28-atom frames within
    1e-5, where one atom in another image moves a centre by L / 28."""
    import torch

    from groan_rs_tpu_torch import testing
    from groan_rs_tpu_torch.ops import kernels as K

    pos, est, box, w = (torch.from_numpy(x).to(dev) for x in testing.refine_tie_atoms())
    got, want = K.bai_breen_refine(pos, w, box, est), K.bai_breen_refine_plain(pos, w, box, est)
    bad = (got != want).any(1).nonzero()
    check(len(bad) == 0, f"K2 refine tie sets: {len(pos)} tie coordinates, each "
          f"alone in a thread, unwrapped into the twin's image ({len(bad)} differ)")
    pos, est, box = (torch.from_numpy(x).to(dev) for x in testing.refine_tie_sets())
    na = pos.shape[1]
    w = torch.from_numpy(np.random.default_rng(3).uniform(1.0, 16.0, na)
                         .astype(np.float32)).to(dev)
    jump = float(box.min()) / na
    for wt in (None, w):
        e = max_err(K.bai_breen_refine(pos, wt, box, est),
                    K.bai_breen_refine_plain(pos, wt, box, est))
        check(e < 1e-5, f"K2 refine tie sets, {pos.shape[0]} frames of {na} atoms, "
              f"weights={wt is not None}: within 1e-5 of the twin ({e:.2e}; an atom "
              f"in another image would move a centre by >= {jump:.3f})")


def kernel_checks(dev):
    """Phase 3 -> {kernel name: record} for the JSON line."""
    import torch

    from groan_rs_tpu_torch.ops import kernels as K

    g = torch.Generator(device="cpu").manual_seed(0)

    def uniform(*shape, lo=0.0, hi=1.0):
        return (torch.rand(*shape, generator=g) * (hi - lo) + lo).to(dev)

    from groan_rs_tpu_torch.testing import synthetic_sizes

    n_prot, n_mem = synthetic_sizes(N_ATOMS)
    n_pep = min(400, n_prot)
    box_len = 21.0
    boxes = torch.full((BATCH, 3), box_len, device=dev)
    boxes[:, 2] = 20.5  # unequal axes
    rec = {}
    flush = torch.zeros(25 * 2 ** 20, device=dev)  # 100 MB: twice the L2

    # ---- K1 / K2 at the main path's shapes (tolerance 2e-3) ----------
    shapes = {f"protein [{BATCH}, {n_prot}, 3] masses":
              (n_prot, uniform(n_prot, lo=1.0, hi=16.0)),
              f"membrane [{BATCH}, {n_mem}, 3] geometric": (n_mem, None)}
    k1_err = k2_err = 0.0
    for label, (n, w) in shapes.items():
        pos = uniform(BATCH, n, 3, lo=-2.0, hi=box_len + 2.0)
        est = K.bai_breen_estimate(pos, w, boxes)
        est_p = K.bai_breen_estimate_plain(pos, w, boxes)
        e1 = max_err(est, est_p)
        ctr = K.bai_breen_refine(pos, w, boxes, est)
        ctr_p = K.bai_breen_refine_plain(pos, w, boxes, est)
        e2 = max_err(ctr, ctr_p)
        say(f"  K1 {label}: max |kernel - twin| = {e1:.3e}")
        say(f"  K2 {label}: max |kernel - twin| = {e2:.3e}")
        check(e1 < 2e-3 and e2 < 2e-3, f"K1/K2 agree with their twins at {label}")
        k1_err, k2_err = max(k1_err, e1), max(k2_err, e2)
        k1_ms, k1_ev = timed(lambda: K.bai_breen_estimate(pos, w, boxes), 50,
                             KERNEL_NAMES["bai_breen_estimate"])
        k1_plain, k1p_ev = timed(
            lambda: K.bai_breen_estimate_plain(pos, w, boxes), 10)
        k2_ms, k2_ev = timed(lambda: K.bai_breen_refine(pos, w, boxes, est), 50,
                             KERNEL_NAMES["bai_breen_refine"])
        k2_plain, k2p_ev = timed(
            lambda: K.bai_breen_refine_plain(pos, w, boxes, est), 10)
        say(f"  K1 {label}: kernel {k1_ms:.4f} ms device ({k1_ev:.4f} ms "
            f"per call by events), twin {k1_plain:.4f} ms device ({k1p_ev:.4f})")
        say(f"  K2 {label}: kernel {k2_ms:.4f} ms device ({k2_ev:.4f} ms "
            f"per call by events), twin {k2_plain:.4f} ms device ({k2p_ev:.4f})")
        k1_fl = device_ms(lambda: K.bai_breen_estimate(pos, w, boxes), 50,
                          KERNEL_NAMES["bai_breen_estimate"], flush)
        k2_fl = device_ms(lambda: K.bai_breen_refine(pos, w, boxes, est), 50,
                          KERNEL_NAMES["bai_breen_refine"], flush)
        say(f"  K1 {label}: kernel {k1_fl} ms device with the L2 flushed; "
            f"K2 {k2_fl} ms")
        rec["bai_breen_estimate"] = dict(
            ms=k1_ms, plain_ms=k1_plain, shape=label, ms_l2_flushed=k1_fl,
            bound=k1_bound(BATCH, n, w is not None))
        rec["bai_breen_refine"] = dict(
            ms=k2_ms, plain_ms=k2_plain, shape=label, ms_l2_flushed=k2_fl,
            bound=k2_bound(BATCH, n, w is not None))

    # ---- K1 / K2 small cases (tolerances 1e-4 / 2e-4) ----------------
    for n in (1, 300, 2049, 5000):
        pos = uniform(3, n, 3, lo=-1.0, hi=6.0)
        bx = uniform(3, 3, lo=4.0, hi=6.0)
        w = uniform(n, lo=1.0, hi=16.0)
        w[::5] = 0.0  # masked atoms
        for wt in (None, w):
            e1 = max_err(K.bai_breen_estimate(pos, wt, bx),
                         K.bai_breen_estimate_plain(pos, wt, bx))
            e2 = max_err(K.bai_breen_center(pos, wt, bx),
                         K.bai_breen_center_plain(pos, wt, bx))
            check(e1 < 1e-4 and e2 < 2e-4,
                  f"K1/K2 n={n} weights={'masked masses' if wt is not None else 'none'}"
                  f" ({e1:.1e}, {e2:.1e})")
    empty = K.bai_breen_estimate(uniform(2, 50, 3), torch.zeros(50, device=dev),
                                 torch.full((3,), 5.0, device=dev))
    check(bool(torch.isnan(empty).all()), "K1: an empty selection gives NaN")
    view = uniform(2, 1000, 3, lo=0.0, hi=5.0)[:, 100:600]  # strided frame view
    e = max_err(K.bai_breen_center(view, None, torch.full((3,), 5.0, device=dev)),
                K.bai_breen_center_plain(view.contiguous(), None,
                                         torch.full((2, 3), 5.0, device=dev)))
    check(e < 2e-4, f"K1/K2 read a slice view in place ({e:.1e})")
    k1_checks(dev, uniform)
    k2_checks(dev, uniform)
    k2_tie_checks(dev)

    # ---- K3 small cases: exact counts, min within 1e-6 ---------------
    bx3 = torch.tensor([[5.0, 6.0, 7.0]] * 2, device=dev)
    for n, m in ((300, 500), (257, 129), (1, 1), (512, 256), (513, 257)):
        a = uniform(2, n, 3) * bx3[:, None, :]
        b = uniform(2, m, 3) * bx3[:, None, :]
        for cut in (0.0, 0.2, 0.7, 1.0):
            dk, ck = K.pair_reduce(a, b, bx3, cut)
            dp, cp = K.pair_reduce_plain(a, b, bx3, cut)
            check(max_err(dk, dp) <= 1e-6 and bool((ck == cp).all()),
                  f"K3 {n}x{m} cutoff {cut}")
    a = torch.tensor([[[0.05, 0.05, 0.05]]], device=dev)
    b = torch.tensor([[[4.95, 5.95, 6.95]]], device=dev)
    dk, _ = K.pair_reduce(a, b, bx3[:1], 0.0)
    check(abs(float(dk[0]) - float(np.sqrt(3 * 0.1 ** 2))) < 1e-5,
          "K3 pair across the periodic boundary")
    k3_tie_checks(dev)
    k3_role_checks(dev, uniform)

    # ---- K3 at the main path's shape: peptide x membrane x 12 frames ---
    pep = uniform(BATCH, n_pep, 3, lo=8.0, hi=13.0)
    mem = uniform(BATCH, n_mem, 3, lo=0.0, hi=box_len)
    dk, ck = K.pair_reduce(pep, mem, boxes, 0.5)
    dp, cp = K.pair_reduce_plain(pep, mem, boxes, 0.5)
    e3 = max_err(dk, dp)
    k3_shape = f"[{BATCH}, {n_pep}, 3] x [{BATCH}, {n_mem}, 3]"
    say(f"  K3 {k3_shape}: min err {e3:.3e}, counts "
        f"{ck.tolist()} vs {cp.tolist()}")
    check(e3 < 2e-3 and bool((ck == cp).all()),
          "K3 agrees with its twin at the main path's shape")
    check(same_bits(dk, dp), "K3 min bits equal the twin's at the main path's shape")
    check(all(same_bits(K.pair_reduce(pep, mem, boxes, 0.5)[0], dk)
              and bool((K.pair_reduce(pep, mem, boxes, 0.5)[1] == ck).all())
              for _ in range(5)), "K3 at the main shape: five calls, identical bits")
    k3_ms, k3_ev = timed(lambda: K.pair_reduce(pep, mem, boxes, 0.5), 20,
                         KERNEL_NAMES["pair_reduce"])
    k3_plain, k3p_ev = timed(lambda: K.pair_reduce_plain(pep, mem, boxes, 0.5), 3)
    k3_fl = device_ms(lambda: K.pair_reduce(pep, mem, boxes, 0.5), 20,
                      KERNEL_NAMES["pair_reduce"], flush)
    say(f"  K3: kernel {k3_ms:.4f} ms device ({k3_ev:.4f} ms per call by "
        f"events; {k3_fl} ms with the L2 flushed), twin {k3_plain:.4f} ms "
        f"device ({k3p_ev:.4f})")
    rec["pair_reduce"] = dict(ms=k3_ms, plain_ms=k3_plain, shape=k3_shape,
                              ms_l2_flushed=k3_fl,
                              bound=k3_bound(BATCH, n_pep, n_mem))
    del flush
    for k, r in rec.items():
        say(f"  {k}: bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
            f"{100 * r['bound'][0] / r['ms']:.1f}% of it at {r['ms']:.4f} ms, "
            f"{100 * r['bound'][0] / (r['ms_l2_flushed'] or float('inf')):.1f}% "
            f"with the L2 flushed")
    rec["bai_breen_estimate"]["max_abs_err"] = k1_err
    rec["bai_breen_refine"]["max_abs_err"] = k2_err
    rec["pair_reduce"]["max_abs_err"] = e3
    return rec


def com_cog_checks(torch, dt, w, dist, n_prot, n_mem):
    """The COM-COG distance of the kernel path (K1 + K2 on the card)
    against the twin path (the same port functions on CPU tensors), on the
    resident window's dequantised parity frames.

    A refined centre jumps by n L / N when the unwrap boundary e + L/2 of
    its estimate crosses a plane of n atoms with one quantised coordinate
    (`testing.center_jump_bound`), and the membrane slab fills the box in
    x and y.  So the two paths may differ by 1e-4 plus what the atoms that
    change image between the kernel's and the twin's membrane estimates
    explain, and no more.  Then, to see which float32 step of the estimate
    moves it across a plane, the distance from estimates whose angles are
    rounded as the twin rounds them, as the twin without its wrap, and as
    the kernel (y = x RN(4/L), angle pi/2 y), each summed in float64,
    against the float64 oracle's estimate."""
    from groan_rs_tpu_torch import testing
    from groan_rs_tpu_torch.ops import center as C
    from groan_rs_tpu_torch.ops import kernels as K
    from groan_rs_tpu_torch.ops import pbc

    f = PARITY_FRAMES
    pos = dt.pos[:f].float() * dt.inv_prec[:f, None, None]
    boxes = dt.boxes[:f]
    w = torch.as_tensor(w, dtype=torch.float32, device=pos.device)
    mem = slice(n_prot, n_prot + n_mem)

    def path(p, bx, wt, est=None):
        ca = C.center(p[:, :n_prot], bx, weights=wt)
        cb = (C.center(p[:, mem], bx) if est is None
              else K.bai_breen_refine(p[:, mem], None, bx, est))
        return pbc.distance(ca, cb, bx)

    d_k = path(pos, boxes, w)
    e = float((d_k.cpu().double() - torch.from_numpy(dist[:f]).double()).abs().max())
    check(e <= 1e-6, f"the kernel path here is the pipeline's ({e:.1e})")
    pos_c, boxes_c = pos.cpu(), boxes.cpu()
    d_p = path(pos_c, boxes_c, w.cpu())
    e_k = K.bai_breen_estimate(pos[:, mem], None, boxes)
    e_p = K.bai_breen_estimate(pos_c[:, mem], None, boxes_c)
    flips, jump = testing.center_jump_bound(pos_c[:, mem].numpy(), e_k.cpu().numpy(),
                                            e_p.numpy(), boxes_c.numpy())
    gap = (d_k.cpu() - d_p).abs().double().numpy()
    allowed = 1e-4 + np.sqrt((jump ** 2).sum(1))
    for i in np.flatnonzero((flips.sum(1) > 0) | (gap > 1e-5)):
        say(f"  frame {i}: kernel path {float(d_k[i]):.7f}, twin path "
            f"{float(d_p[i]):.7f}, gap {gap[i]:.3e}; atoms changing image per "
            f"axis {flips[i].tolist()} (bound {np.sqrt((jump[i] ** 2).sum()):.3e}); "
            f"estimates {e_k[i].tolist()} vs {e_p[i].tolist()}")
    check(bool((gap <= allowed).all()),
          f"kernel path vs twin path, COM-COG distance over {f} frames: max gap "
          f"{gap.max():.3e}, within 1e-4 plus the image changes "
          f"({int(flips.sum())} atoms in all)")
    d_kp = path(pos, boxes, w, e_p.to(pos.device))
    e = float((d_kp.cpu() - d_p).abs().max())
    check(e <= 1e-4, f"K2 on the card around the twin's estimate gives the twin "
          f"path's distance ({e:.1e}): the gap comes from K1's estimate")

    x = pos[:, mem].double()
    L = boxes[:, None, :].double()
    x32, L32 = pos[:, mem], boxes[:, None, :]
    two_pi, four = (torch.tensor(v, device=pos.device) for v in (2 * np.pi, 4.0))
    angles = {  # float32 angle arguments, then float64 trig and sums
        "twin": ((x32 - L32 * torch.floor(x32 / L32)) * (two_pi / L32)).double(),
        "twin without its wrap": (x32 * (two_pi / L32)).double(),
        "kernel": (x32 * (four / L32)).double() * (np.pi / 2),
        "float64": torch.remainder(x, L) * (2 * np.pi / L)}
    got = {}
    for name, th in angles.items():
        est = (torch.atan2(-torch.sin(th).sum(1), -torch.cos(th).sum(1)) + np.pi) \
            * boxes.double() / (2 * np.pi)
        got[name] = path(pos, boxes, w, est.float()).cpu().double()
    got["kernel, float32 sums"], got["twin, float32 sums"] = d_k.cpu().double(), d_p.double()
    ref = got["float64"]
    say("  COM-COG distance by the estimate's arithmetic, max |d - d(float64 "
        "estimate)| over the frames: " + ", ".join(
            f"{k} {float((v - ref).abs().max()):.3e}" for k, v in got.items()))
    for i in range(f):
        if max(abs(float(v[i] - ref[i])) for v in got.values()) > 1e-5:
            say(f"    frame {i}: " + ", ".join(f"{k} {float(v[i]):.7f}"
                                              for k, v in got.items()))


def profile_pass(torch, label, fn):
    """One profiled pass: wall clock, device busy share, top device ops ->
    (wall seconds, device compute seconds).  Device activity only: a
    triclinic pass launches ~10^5 kernels, whose host-side events made
    the profiler's post-processing take minutes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _device_events(prof)
    copy_us = sum(us for k, us, _ in rows if "memcpy" in k.lower())
    busy_us = sum(us for k, us, _ in rows if "memcpy" not in k.lower())
    say(f"  profile {label}: wall {wall:.4f} s (profiled), device compute "
        f"{busy_us / 1e6:.4f} s = {100 * busy_us / 1e6 / wall:.1f}% busy, "
        f"memcpy {copy_us / 1e6:.4f} s")
    for k, us, c in rows[:8]:
        say(f"    {us / 1e3:9.3f} ms  x{c:<5d} {k[:90]}")
    return wall, busy_us / 1e6


def phase_seconds(phase, since):
    """Print a phase's seconds; -> the clock for the next phase."""
    now = time.perf_counter()
    say(f"phase {phase} seconds: {now - since:.1f}")
    return now


def cached_xtc(path, n_frames, build):
    """`path` when it holds an `N_ATOMS` x `n_frames` trajectory, else
    `build(path)` first (the build directory survives within one run)."""
    from groan_rs_tpu_torch.io import native

    if os.path.exists(path):
        offs, _, _, nat = native.xtc_scan(path)
        if len(offs) == n_frames and nat == N_ATOMS:
            return path
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    build(path)
    say(f"  trajectory {os.path.basename(path)} written in "
        f"{time.perf_counter() - t0:.1f} s")
    return path


def triclinic_xtc(n_frames):
    from groan_rs_tpu_torch import testing
    from groan_rs_tpu_torch.ops import kernels as K

    return cached_xtc(
        os.path.join(K.BUILD_DIR, f"smoke_dodecahedron_{N_ATOMS}_{n_frames}.xtc"),
        n_frames, lambda p: testing.build_trajectory_triclinic(p, N_ATOMS, n_frames))


def no_launches(counts, what):
    check(all(v == 0 for v in counts.values()),
          f"{what}: K1, K2 and K3 never launched ({counts})")


def sync_checks(torch, h, frames, n_prot, n_mem):
    """The triclinic step's pieces make no host synchronisation
    (`torch.cuda.set_sync_debug_mode("error")` raises on one); report
    whether `torch.linalg.inv` and `torch.linalg.det` would have made one."""
    from groan_rs_tpu_torch.ops import center as C
    from groan_rs_tpu_torch.ops import distances as D
    from groan_rs_tpu_torch.ops import pbc

    def syncs(fn):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            return True
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return False

    pep, mem = frames[:, :min(400, n_prot)], frames[:, n_prot:n_prot + n_mem]
    small = mem[:, :20000]
    for label, fn in (
            ("box_inverse (torch.linalg.inv_ex)", lambda: pbc.box_inverse(h)),
            ("box_volume (rule of Sarrus)", lambda: pbc.box_volume(h)),
            ("center_triclinic", lambda: C.center_triclinic(mem, h)),
            ("min_image_triclinic_frames",
             lambda: pbc.min_image_triclinic_frames(frames[:, :n_prot], h)),
            ("min_distance_triclinic", lambda: D.min_distance_triclinic(pep, small, h)),
            ("contact_count_triclinic",
             lambda: D.contact_count_triclinic(pep, small, h, 0.4)),
            ("pair_distance_histogram (matrices)",
             lambda: D.pair_distance_histogram(pep, small, h, 2.0, 200))):
        check(not syncs(fn), f"{label} makes no host synchronisation")
    say(f"  torch.linalg.inv synchronises the host: "
        f"{syncs(lambda: torch.linalg.inv(h))}; torch.linalg.det: "
        f"{syncs(lambda: torch.linalg.det(h))}")
    h64 = h.double().cpu()
    e_inv = float(((pbc.box_inverse(h).double().cpu() - torch.linalg.inv(h64)).abs()
                   / torch.linalg.inv(h64).abs().max()).max())
    e_vol = float(((pbc.box_volume(h).double().cpu() - torch.linalg.det(h64).abs())
                   / torch.linalg.det(h64).abs()).abs().max())
    check(e_inv < 1e-6 and e_vol < 3e-7, f"box inverse within {e_inv:.1e} and "
          f"volume within {e_vol:.1e} (relative) of float64")


def triclinic_phase(torch, dev):
    """Phase 8 -> (pipeline, runner, XTC, resident window, launch counts,
    per-batch device ms of the pair path and the centres)."""
    from groan_rs_tpu_torch import convert, testing
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.models import TrajectoryAnalysis
    from groan_rs_tpu_torch.ops import center as C
    from groan_rs_tpu_torch.ops import distances as D
    from groan_rs_tpu_torch.ops import kernels as K

    say(f"phase 8: triclinic main path, {N_ATOMS} atoms x {N_FRAMES} frames, "
        "rhombic dodecahedron")
    xtc = triclinic_xtc(N_FRAMES)
    offs, _, _, nat = native.xtc_scan(xtc)
    c0, b9, *_ = native.xtc_read_frames(xtc, offs[:1], nat)
    h0 = b9[0].reshape(3, 3)
    say(f"  box rows {h0.tolist()}, volume "
        f"{abs(np.linalg.det(h0.astype(np.float64))):.1f} nm^3; frame-0 "
        f"coordinates in [{c0[0].min():.4f}, {c0[0].max():.4f}] nm")
    state = testing.synthetic_state(c0[0], h0)
    system = convert.system_from_state(state)
    pipe = (TrajectoryAnalysis(system, device=dev, triclinic=True)
            .add_com("Protein", name="com")
            .add_distance("Protein", "Membrane", com=(True, False), name="dist")
            .add_rmsd("Protein", reference=system, name="rmsd")
            .add_min_distance("Peptide", "Membrane", name="mindist")
            .add_contacts("Peptide", "Membrane", 0.4, name="contacts"))
    runner = pipe.runner()
    say(f"  shipped atoms {len(runner.sel)}, wire {runner.wire}, box "
        f"{runner.engine.box_form}")
    n_prot, n_mem = testing.synthetic_sizes(N_ATOMS)

    K.reset_launch_counts()
    passes = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = runner.run(xtc, batch_size=BATCH)
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t0)
    clocks = {k: round(sum(v), 4) for k, v in runner.engine.last_stage_seconds.items()}
    say(f"  streamed passes: {passes[0]:.4f} s (first), {passes[1]:.4f} s "
        f"= {N_FRAMES / passes[1]:.2f} frames/s; host clocks of the last "
        f"{clocks}, fetch {runner.engine.last_fetch_seconds:.4f} s")
    for k in ("com", "dist", "rmsd", "mindist", "contacts"):
        v = out[k]
        check(v.shape[0] == N_FRAMES and bool(np.isfinite(v).all()),
              f"{k}: {v.shape} {v.dtype} finite")

    w = state["mass"][:n_prot]
    coords, b9s, *_ = native.xtc_read_frames(xtc, offs[:PARITY_FRAMES], nat,
                                             stop_after=n_prot + n_mem)
    boxes = b9s.reshape(-1, 3, 3)
    t0 = time.perf_counter()
    errs = {"com": 0.0, "dist": 0.0, "rmsd": 0.0}
    for f in range(PARITY_FRAMES):
        p, h = coords[f], boxes[f]
        ca = testing.host_refined_center_triclinic(p[:n_prot], h, w)
        cb = testing.host_refined_center_triclinic(p[n_prot:], h)
        # a centre is defined up to a lattice vector: compare minimum images
        gap = testing.host_min_image_triclinic(out["com"][f] - ca, h)
        d = testing.host_min_image_triclinic(ca - cb, h)
        want = testing.host_kabsch_rmsd_triclinic(c0[0][:n_prot], p[:n_prot],
                                                  h0, h, w)
        errs["com"] = max(errs["com"], float(np.abs(gap).max()))
        errs["dist"] = max(errs["dist"], abs(float(out["dist"][f])
                                             - float(np.sqrt((d * d).sum()))))
        errs["rmsd"] = max(errs["rmsd"], abs(float(out["rmsd"][f]) - want))
    say(f"  float64 oracles of com, dist, rmsd over {PARITY_FRAMES} frames in "
        f"{time.perf_counter() - t0:.1f} s")
    for k, e in errs.items():
        check(e < 2e-3, f"{k} vs triclinic float64 oracle over {PARITY_FRAMES} "
              f"frames (max err {e:.3e})")
    for f in range(2):
        p = coords[f]
        t0 = time.perf_counter()
        best, lo, hi = testing.host_pairs_triclinic(p[:min(400, n_prot)],
                                                    p[n_prot:], boxes[f], 0.4)
        say(f"  pair oracle frame {f}: {time.perf_counter() - t0:.1f} s")
        e = abs(float(out["mindist"][f]) - best)
        check(e < 1e-4, f"mindist frame {f} vs float64 oracle "
              f"({out['mindist'][f]:.6f} vs {best:.6f})")
        check(lo <= out["contacts"][f] <= hi,
              f"contacts frame {f}: {out['contacts'][f]} within the oracle's "
              f"[{lo}, {hi}] (pairs within 1e-5 nm of the cutoff may go either way)")
    ortho = testing.host_refined_center(c0[0][:n_prot], np.diag(h0), w)
    tri = testing.host_refined_center_triclinic(c0[0][:n_prot], h0, w)
    gap = testing.host_min_image_triclinic(ortho - tri, h0)
    say(f"  frame-0 COM: orthorhombic treatment of the diagonal {ortho.tolist()}, "
        f"triclinic oracle {tri.tolist()}, port {out['com'][0].tolist()}")
    check(float(np.sqrt((gap * gap).sum())) > 1.0,
          f"the orthorhombic treatment is {np.sqrt((gap * gap).sum()):.3f} nm off "
          "(> 1 nm): the triclinic checks can fail")

    t0 = time.perf_counter()
    dt = runner.load_device(xtc, batch_size=BATCH)
    torch.cuda.synchronize()
    say(f"  load_device {time.perf_counter() - t0:.4f} s, resident "
        f"{dt.nbytes / 1e6:.1f} MB ({dt.kind}, {dt.n_frames} frames, boxes "
        f"{tuple(dt.boxes.shape)})")
    check(dt.kind == "q16" and dt.box_form == "matrix",
          "the dodecahedron stays on the q16 wire, box matrices resident")
    for label, fn in (("run_resident_fused", runner.engine.run_resident_fused),
                      ("run_resident", runner.engine.run_resident)):
        t0 = time.perf_counter()
        res = fn(dt, batch_size=BATCH)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        say(f"  {label}: {t:.4f} s = {N_FRAMES / t:.2f} frames/s")
        for k in ("com", "dist", "rmsd", "mindist", "contacts"):
            e = float(np.abs(res[k].astype(np.float64) - out[k]).max())
            check(e <= 1e-6, f"{label} {k} equals streamed (max diff {e:.1e})")
    counts = dict(K.launch_counts)
    no_launches(counts, "triclinic main path (streamed and resident)")

    frames = dt.pos[:BATCH].float() * dt.inv_prec[:BATCH, None, None]
    hb = dt.boxes[:BATCH]
    sync_checks(torch, hb, frames, n_prot, n_mem)
    pep, mem = frames[:, :min(400, n_prot)], frames[:, n_prot:n_prot + n_mem]
    wt = torch.as_tensor(w, device=dev)
    piece_ms = {}
    for k, fn, reps in (
            ("min_distance_triclinic",
             lambda: D.min_distance_triclinic(pep, mem, hb), 1),
            ("contact_count_triclinic",
             lambda: D.contact_count_triclinic(pep, mem, hb, 0.4), 1),
            ("center_triclinic protein (masses)",
             lambda: C.center_triclinic(frames[:, :n_prot], hb, weights=wt), 5),
            ("center_triclinic membrane", lambda: C.center_triclinic(mem, hb), 5)):
        piece_ms[k], ev = timed(fn, reps)
        say(f"  {k}: {piece_ms[k]:.4f} ms device per {BATCH}-frame batch "
            f"(profiler; {ev:.4f} ms by CUDA events, idle gaps included)")
    no_launches(dict(K.launch_counts), "phase 8's piece timings")
    return pipe, runner, xtc, dt, counts, piece_ms


def triclinic_observables_phase(torch, dev, main_pipe):
    """Phase 9 -> (launch counts, its runner, its resident window)."""
    from groan_rs_tpu_torch import convert, testing
    from groan_rs_tpu_torch.core.dimension import Dimension
    from groan_rs_tpu_torch.core.shapes import Cylinder
    from groan_rs_tpu_torch.errors import GroupError
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.models import TrajectoryAnalysis, run_many
    from groan_rs_tpu_torch.ops import kernels as K
    from groan_rs_tpu_torch.parallel import FrameEngine

    say(f"phase 9: triclinic observables, full topology, every atom shipped, "
        f"{BATCH} frames")
    xtc = triclinic_xtc(BATCH)
    offs, _, _, nat = native.xtc_scan(xtc)
    coords, b9s, *_ = native.xtc_read_frames(xtc, offs[:2], nat)
    boxes = b9s.reshape(-1, 3, 3)
    h0 = boxes[0]
    state = testing.synthetic_state(coords[0], h0, topology="full")
    system = convert.system_from_state(state)
    span = ((0.0, float(h0[0, 0])), (0.0, float(h0[1, 1])))
    pipe = testing.add_observables(
        TrajectoryAnalysis(system, device=dev, triclinic=True), state, None,
        span=span)
    runner = pipe.runner(ship="auto")
    check(runner.sel is None, "ship='auto' ships all atoms (water is touched)")
    try:
        TrajectoryAnalysis(system, device=dev, triclinic=True).add_in_shape(
            "Water", Cylinder(*testing.cylinder_args(np.diag(h0)), Dimension.Z))
        raised = None
    except GroupError as e:
        raised = e.code
    check(raised == "InvalidSimBox", f"add_in_shape refuses a triclinic pass "
          f"(GroupError {raised})")

    K.reset_launch_counts()
    passes = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = runner.run(xtc, batch_size=BATCH)
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t0)
    say(f"  streamed passes: {passes[0]:.4f} s (first), {passes[1]:.4f} s "
        f"= {BATCH / passes[1]:.2f} frames/s")
    undefined = testing.undefined_sites(native.xtc_read_frames(xtc, offs, nat)[0], nat)
    for k, v in out.items():
        if k not in ("times", "steps"):
            nan = undefined.get(k, np.zeros(v.shape, bool))
            note = (f" where defined ({int(nan.sum())} items have a zero-length "
                    "bond in the decoded frame)" if k in undefined else "")
            check(v.shape[0] == BATCH and bool((np.isfinite(v) | nan).all()),
                  f"{k}: {v.shape} {v.dtype} finite{note}")
    t0 = time.perf_counter()
    errs = testing.observable_errors(out, coords, boxes, state, None, rdf_frames=1)
    say(f"  triclinic float64 oracles over 2 frames (the RDF on 1) in "
        f"{time.perf_counter() - t0:.1f} s")
    for k, (e, bound) in errs.items():
        check(e <= bound, f"{k} vs triclinic float64 oracle: {e:.3e} (bound {bound:g})")

    t0 = time.perf_counter()
    dt = runner.load_device(xtc, batch_size=BATCH)
    torch.cuda.synchronize()
    say(f"  load_device {time.perf_counter() - t0:.4f} s, resident "
        f"{dt.nbytes / 1e6:.1f} MB ({dt.kind}, {dt.box_form})")
    for label, fn in (("run_resident_fused", runner.engine.run_resident_fused),
                      ("run_resident", runner.engine.run_resident)):
        t0 = time.perf_counter()
        res = fn(dt, batch_size=BATCH)
        torch.cuda.synchronize()
        say(f"  {label}: {time.perf_counter() - t0:.4f} s")
        check(all(np.array_equal(np.isnan(res[k]), np.isnan(out[k])) for k in res
                  if res[k].dtype.kind == "f"), f"{label}: NaN where streamed is")
        worst = max(float(np.nanmax(np.abs(res[k].astype(np.float64) - out[k])))
                    for k in res)
        check(worst <= 1e-6, f"{label} equals streamed (max diff {worst:.1e})")

    fetches = []
    fetch = FrameEngine.fetch_packed_many

    def counted(sets):
        fetches.append(len(sets))
        return fetch(sets)

    FrameEngine.fetch_packed_many = staticmethod(counted)
    try:
        many = run_many([pipe, main_pipe], dt, batch_size=BATCH)
    finally:
        FrameEngine.fetch_packed_many = staticmethod(fetch)
    check(fetches == [2], f"run_many made one packed fetch of 2 passes ({fetches})")
    alone = [runner.run(dt, batch_size=BATCH),
             main_pipe.runner(ship="all").run(dt, batch_size=BATCH)]
    for got, want in zip(many, alone):
        same = set(got) == set(want) and all(
            np.array_equal(got[k], want[k], equal_nan=want[k].dtype.kind == "f")
            for k in want)
        check(same, f"run_many equals run(dt) bit for bit ({len(want)} keys)")
    counts = dict(K.launch_counts)
    no_launches(counts, "triclinic observables (streamed, resident, run_many)")
    return counts, runner, dt


def observables_phase(torch, xtc, offs, nat, frame0, box, main_pipe, dev):
    """Phase 7 -> (K1/K2/K3 launches of its streamed pass, its runner,
    its resident window)."""
    from groan_rs_tpu_torch import convert, testing
    from groan_rs_tpu_torch.core.dimension import Dimension
    from groan_rs_tpu_torch.core.shapes import Cylinder
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.models import TrajectoryAnalysis, run_many
    from groan_rs_tpu_torch.ops import kernels as K
    from groan_rs_tpu_torch.parallel import FrameEngine

    say("phase 7: observables pass, full topology, every atom shipped")
    t0 = time.perf_counter()
    state = testing.synthetic_state(frame0, box, topology="full")
    system = convert.system_from_state(state)
    cyl = Cylinder(*testing.cylinder_args(box), Dimension.Z)
    pipe = testing.add_observables(TrajectoryAnalysis(system, device=dev),
                                   state, cyl)
    runner = pipe.runner(ship="auto")
    say(f"  system + pipeline built in {time.perf_counter() - t0:.4f} s "
        f"({len(state['bonds'])} bonds, {len(pipe.order_pairs['order'][0])} "
        f"order pairs, {len(state['sites']['water_angles'])} angles, "
        f"{len(state['sites']['lipid_dihedrals'])} dihedrals)")
    check(runner.sel is None, "ship='auto' ships all atoms (water is touched)")

    K.reset_launch_counts()
    passes = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = runner.run(xtc, batch_size=BATCH)
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t0)
    counts = dict(K.launch_counts)
    clocks = {k: round(sum(v), 4) for k, v in runner.engine.last_stage_seconds.items()}
    say(f"  streamed passes: {passes[0]:.4f} s (first), {passes[1]:.4f} s "
        f"= {N_FRAMES / passes[1]:.2f} frames/s; host clocks of the last "
        f"{clocks}, fetch {runner.engine.last_fetch_seconds:.4f} s")
    say(f"  launches during the streamed passes {counts}")
    for k in ("bai_breen_estimate", "bai_breen_refine"):
        check(counts[k] > 0, f"{k} launched on the observables path")
    coords, b9s, *_ = native.xtc_read_frames(xtc, offs, nat)
    undefined = testing.undefined_sites(coords, nat)
    for k, v in out.items():
        if k not in ("times", "steps"):
            nan = undefined.get(k, np.zeros(v.shape, bool))
            note = (f" where defined ({int(nan.sum())} items have a zero-length "
                    "bond in the decoded frame)" if k in undefined else "")
            check(v.shape[0] == N_FRAMES and bool((np.isfinite(v) | nan).all()),
                  f"{k}: {v.shape} {v.dtype} finite{note}")
    coords, b9s = coords[:2], b9s[:2]
    t0 = time.perf_counter()
    errs = testing.observable_errors(out, coords, b9s[:, [0, 4, 8]], state, cyl)
    say(f"  float64 oracles over 2 frames in {time.perf_counter() - t0:.1f} s")
    for k, (e, bound) in errs.items():
        check(e <= bound, f"{k} vs float64 oracle: {e:.3e} (bound {bound:g})")

    t0 = time.perf_counter()
    dt = runner.load_device(xtc, batch_size=BATCH)
    torch.cuda.synchronize()
    say(f"  load_device {time.perf_counter() - t0:.4f} s, resident "
        f"{dt.nbytes / 1e6:.1f} MB ({dt.kind}, {dt.n_frames} frames)")
    # every result here is deterministic on the card: integer counts are
    # exact under atomics, and the float density profiles accumulate
    # with index_put_(accumulate=True), which sums each bin in a fixed
    # (sorted) order
    for label, fn in (("run_resident_fused", runner.engine.run_resident_fused),
                      ("run_resident", runner.engine.run_resident)):
        res = fn(dt, batch_size=BATCH)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            fn(dt, batch_size=BATCH)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        say(f"  {label}: {best:.4f} s = {N_FRAMES / best:.2f} frames/s")
        worst = max(float(np.nanmax(np.abs(res[k].astype(np.float64) - out[k])))
                    for k in res)
        check(all(np.array_equal(np.isnan(res[k]), np.isnan(out[k])) for k in res
                  if res[k].dtype.kind == "f"), f"{label}: NaN where streamed is")
        check(worst <= 1e-6, f"{label} equals streamed (max diff {worst:.1e})")

    fetches = []
    fetch = FrameEngine.fetch_packed_many

    def counted(sets):
        fetches.append(len(sets))
        return fetch(sets)

    FrameEngine.fetch_packed_many = staticmethod(counted)
    try:
        t0 = time.perf_counter()
        many = run_many([pipe, main_pipe], dt, batch_size=BATCH)
        torch.cuda.synchronize()
        t_many = time.perf_counter() - t0
    finally:
        FrameEngine.fetch_packed_many = staticmethod(fetch)
    check(fetches == [2], f"run_many made one packed fetch of 2 passes ({fetches})")
    t0 = time.perf_counter()
    alone = [runner.run(dt, batch_size=BATCH),
             main_pipe.runner(ship="all").run(dt, batch_size=BATCH)]
    torch.cuda.synchronize()
    t_alone = time.perf_counter() - t0
    for got, want in zip(many, alone):
        same = set(got) == set(want) and all(
            np.array_equal(got[k], want[k], equal_nan=want[k].dtype.kind == "f")
            for k in want)
        check(same, f"run_many equals run(dt) bit for bit ({len(want)} keys)")
    say(f"  run_many {t_many:.4f} s; the two run(dt) calls {t_alone:.4f} s")

    from groan_rs_tpu_torch.ops import distances
    n_prot, n_mem = testing.synthetic_sizes(nat)
    frames = dt.pos[:BATCH].float() * dt.inv_prec[:BATCH, None, None]
    pep, mem = frames[:, :min(400, n_prot)], frames[:, n_prot:n_prot + n_mem]
    rdf_ms = cuda_ms(lambda: distances.pair_distance_histogram(
        pep, mem, dt.boxes[:BATCH], 2.0, 200), 3)
    say(f"  pair_distance_histogram alone, {BATCH} frames x {pep.shape[1]} x "
        f"{mem.shape[1]} pairs: {rdf_ms:.4f} ms per batch (CUDA events)")
    return counts, runner, dt


def main():
    import torch

    from groan_rs_tpu_torch import require_cuda

    # ---- 1. environment ---------------------------------------------
    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    say(smi[dev.index or 0])
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(dev)}, python {sys.version.split()[0]}")

    from groan_rs_tpu_torch import convert, testing
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.models import TrajectoryAnalysis
    from groan_rs_tpu_torch.ops import kernels as K

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    K._load()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.get_lib()
    t_n = time.perf_counter() - t0
    say(f"build: kernels {t_k:.2f} s, native codec {t_n:.2f} s")
    for line in K.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("  nvcc: " + line.strip())

    # ---- 3. kernels against their twins --------------------------------
    say("phase 3: kernels vs twins")
    t_phase = time.perf_counter()
    rec = kernel_checks(dev)
    t_phase = phase_seconds(3, t_phase)

    # ---- 4. main path, streamed ---------------------------------------
    say(f"phase 4: streamed main path, {N_ATOMS} atoms x {N_FRAMES} frames")
    xtc = cached_xtc(os.path.join(K.BUILD_DIR, f"smoke_{N_ATOMS}_{N_FRAMES}.xtc"),
                     N_FRAMES, lambda p: testing.build_trajectory(p, N_ATOMS, N_FRAMES))
    offs, _, _, nat = native.xtc_scan(xtc)
    c0, b9, *_ = native.xtc_read_frames(xtc, offs[:1], nat)
    box = b9[0][[0, 4, 8]]
    state = testing.synthetic_state(c0[0], box)
    system = convert.system_from_state(state)
    pipe = (TrajectoryAnalysis(system, device=dev)
            .add_com("Protein", name="com")
            .add_distance("Protein", "Membrane", com=(True, False), name="dist")
            .add_rmsd("Protein", reference=system, name="rmsd")
            .add_min_distance("Peptide", "Membrane", name="mindist"))
    runner = pipe.runner()
    say(f"  shipped atoms {len(runner.sel)}, wire {runner.wire}")

    t0 = time.perf_counter()
    runner._reader(xtc, BATCH)
    say(f"  opening the reader (frame-index scan): {time.perf_counter() - t0:.4f} s")
    K.reset_launch_counts()
    passes = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = runner.run(xtc, batch_size=BATCH)
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t0)
    clocks = {k: round(sum(v), 4) for k, v in runner.engine.last_stage_seconds.items()}
    say(f"  streamed passes: {passes[0]:.4f} s (first), {passes[1]:.4f} s "
        f"= {N_FRAMES / passes[1]:.2f} frames/s; host clocks of the last "
        f"{clocks}, fetch {runner.engine.last_fetch_seconds:.4f} s")
    for k in ("com", "dist", "rmsd", "mindist"):
        v = out[k]
        check(v.shape[0] == N_FRAMES and bool(np.isfinite(v).all()),
              f"{k}: {v.shape} finite")

    n_prot, n_mem = testing.synthetic_sizes(N_ATOMS)
    w = state["mass"][:n_prot]
    coords, b9s, *_ = native.xtc_read_frames(xtc, offs[:PARITY_FRAMES], nat,
                                             stop_after=n_prot + n_mem)
    ref_com0 = testing.host_refined_center(c0[0][:n_prot], box, w)
    box64 = np.asarray(box, np.float64)
    ref = np.mod(c0[0][:n_prot] + (box64 / 2 - ref_com0), box64) - box64 / 2
    com_h, dist_h, rmsd_h = [], [], []
    for f in range(PARITY_FRAMES):
        p = coords[f]
        ca = testing.host_refined_center(p[:n_prot], box, w)
        cb = testing.host_refined_center(p[n_prot:], box)
        d = ca - cb
        d -= box64 * np.round(d / box64)
        com_h.append(ca)
        dist_h.append(np.sqrt((d * d).sum()))
        rmsd_h.append(testing.host_kabsch_rmsd(ref, np.zeros(3), p[:n_prot], box, w))
    errs = {"com": np.abs(out["com"][:PARITY_FRAMES] - np.asarray(com_h)).max(),
            "dist": np.abs(out["dist"][:PARITY_FRAMES] - np.asarray(dist_h)).max(),
            "rmsd": np.abs(out["rmsd"][:PARITY_FRAMES] - np.asarray(rmsd_h)).max()}
    for k, e in errs.items():
        check(e < 2e-3, f"{k} vs float64 oracle over {PARITY_FRAMES} frames "
              f"(max err {e:.3e})")
    for f in range(2):
        p = coords[f]
        want = testing.host_min_distance(p[:min(400, n_prot)], p[n_prot:], box)
        e = abs(float(out["mindist"][f]) - want)
        check(e < 1e-4, f"mindist frame {f} vs float64 oracle "
              f"({out['mindist'][f]:.6f} vs {want:.6f})")

    t_phase = phase_seconds(4, t_phase)

    # ---- 5. device-resident re-run -------------------------------------
    say("phase 5: device-resident re-run")
    t0 = time.perf_counter()
    dt = runner.load_device(xtc, batch_size=BATCH)
    torch.cuda.synchronize()
    say(f"  load_device {time.perf_counter() - t0:.4f} s, resident "
        f"{dt.nbytes / 1e6:.1f} MB ({dt.kind}, {dt.n_frames} frames)")
    for label, fn in (("run_resident_fused", runner.engine.run_resident_fused),
                      ("run_resident", runner.engine.run_resident)):
        res = fn(dt, batch_size=BATCH)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            fn(dt, batch_size=BATCH)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        say(f"  {label}: {best:.4f} s = {N_FRAMES / best:.2f} frames/s")
        for k in ("com", "dist", "rmsd", "mindist"):
            e = float(np.abs(res[k].astype(np.float64) - out[k]).max())
            check(e <= 1e-6, f"{label} {k} equals streamed (max diff {e:.1e})")
    via_run = runner.run(dt, batch_size=BATCH)
    check(np.array_equal(via_run["times"], out["times"]), "resident times")
    counts = dict(K.launch_counts)  # the main path ends here
    check(np.array_equal(runner.sel, np.arange(n_prot + n_mem)),
          "the pass ships the protein, then the membrane")
    com_cog_checks(torch, dt, w, out["dist"], n_prot, n_mem)

    t_phase = phase_seconds(5, t_phase)

    # ---- 6. the kernels ran on the main path ----------------------------
    say(f"phase 6: launches during the main path (phases 4-5) {counts}")
    for k, v in counts.items():
        check(v > 0, f"{k} launched on the main path")

    # ---- 7. the observables pass at full width --------------------------
    obs_counts, orunner, odt = observables_phase(
        torch, xtc, offs, nat, c0[0], box, pipe, dev)
    t_phase = phase_seconds(7, t_phase)

    # ---- 8. the triclinic main path ----------------------------------------
    tpipe, trunner, txtc, tdt, tri_counts, piece_ms = triclinic_phase(torch, dev)
    t_phase = phase_seconds(8, t_phase)

    # ---- 9. the triclinic observables ------------------------------------
    tobs_counts, tobs_runner, tobs_dt = triclinic_observables_phase(
        torch, dev, tpipe)
    t_phase = phase_seconds(9, t_phase)

    # ---- where the time goes: one profiled pass of each kind -----------
    # the triclinic main path over one batch: phase 9's 12-frame file (the
    # first 12 frames of phase 8's) streamed, and a 12-frame resident window
    from groan_rs_tpu_torch.parallel import DeviceTrajectory

    one = DeviceTrajectory(tdt.pos[:BATCH], tdt.boxes[:BATCH], tdt.inv_prec[:BATCH],
                           tdt.times[:BATCH], tdt.steps[:BATCH], tdt.kind,
                           tdt.box_form)
    one.sel = tdt.sel
    busy = {}
    for label, fn in (
            ("streamed", lambda: runner.run(xtc, batch_size=BATCH)),
            ("resident", lambda: runner.run(dt, batch_size=BATCH)),
            ("observables resident", lambda: orunner.run(odt, batch_size=BATCH)),
            ("triclinic streamed, one batch",
             lambda: trunner.run(triclinic_xtc(BATCH), batch_size=BATCH)),
            ("triclinic resident, one batch", lambda: trunner.run(one, batch_size=BATCH)),
            ("triclinic observables resident",
             lambda: tobs_runner.run(tobs_dt, batch_size=BATCH))):
        if label.startswith("triclinic"):
            K.reset_launch_counts()
        busy[label] = profile_pass(torch, label, fn)
        if label.startswith("triclinic"):
            no_launches(dict(K.launch_counts), f"profiled {label} pass")
    dev_s = busy["triclinic resident, one batch"][1]
    pair_s = (piece_ms["min_distance_triclinic"]
              + piece_ms["contact_count_triclinic"]) / 1e3
    ctr_s = (3 * piece_ms["center_triclinic protein (masses)"]
             + piece_ms["center_triclinic membrane"]) / 1e3
    say(f"  triclinic resident batch: device compute {dev_s:.4f} s; the pair path "
        f"(min distance + contacts, profiled alone) {pair_s:.4f} s = "
        f"{100 * pair_s / dev_s:.1f}%, center_triclinic (3 protein + 1 "
        f"membrane centres) {ctr_s:.4f} s = {100 * ctr_s / dev_s:.1f}%")
    phase_seconds("profiles", t_phase)

    src = {"bai_breen_estimate": ("groan_rs_tpu_torch/csrc/bai_breen.cu",
                                  "groan_rs_tpu/ops/pallas_kernels.py:159"),
           "bai_breen_refine": ("groan_rs_tpu_torch/csrc/bai_breen.cu",
                                "groan_rs_tpu/ops/pallas_kernels.py:250"),
           "pair_reduce": ("groan_rs_tpu_torch/csrc/pair_reduce.cu",
                           "groan_rs_tpu/ops/pallas_kernels.py:27")}
    # no single PyTorch call computes any of the three functions
    no_library = {
        "bai_breen_estimate": "a circular mean of wrapped angles, then atan2",
        "bai_breen_refine": "a mean of positions unwrapped around an estimate",
        "pair_reduce": "per-axis minimum image (torch.cdist has none)"}
    say(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src[k][0], "replaces": src[k][1],
         "launches": counts[k], "max_abs_err": rec[k]["max_abs_err"],
         "ms": rec[k]["ms"], "plain_ms": rec[k]["plain_ms"],
         "bound_ms": rec[k]["bound"][0], "bound_by": rec[k]["bound"][1],
         "pct_of_bound": 100 * rec[k]["bound"][0] / rec[k]["ms"],
         "ms_l2_flushed": rec[k]["ms_l2_flushed"],
         "library_ms": None, "library_none": no_library[k],
         "shape": rec[k]["shape"], "observables_launches": obs_counts[k],
         "triclinic_launches": tri_counts[k] + tobs_counts[k]}
        for k in src]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
