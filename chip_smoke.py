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
   shapes and at ragged, masked, boundary and empty cases; times of both.
4. Main path, streamed: a synthetic 1,000,000-atom membrane-protein system
   (protein 99k, membrane 300k atoms) over SMOKE_FRAMES frames (default
   48), COM + COM distance + fitted RMSD + peptide-membrane min distance at
   batch 12 over the q16 wire; checked against float64 host oracles.
5. Device-resident re-run: load_device, then run_resident_fused and
   run_resident, each equal to the streamed pass within 1e-6.
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

The last two stdout lines are the kernels' JSON record and the result line
`{"ok": true, "device": {...}}`.  Imports nothing of JAX.
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


def device_ms(fn, reps):
    """Device milliseconds per call: the summed device time of everything
    `fn` launches, over `reps` calls (torch.profiler), after one warm-up
    call; None when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(us for _, us, _ in _device_events(prof))
    return total / 1e3 / reps if total > 0 else None


def timed(fn, reps):
    """(device ms per call from the profiler, or from CUDA events when the
    profiler shows no device time; CUDA-event ms per call)."""
    ev = cuda_ms(fn, reps)
    dev = device_ms(fn, reps)
    return (dev if dev is not None else ev), ev


def max_err(x, y):
    """Max |x - y|; NaNs must sit at the same places (empty selections)."""
    import torch

    x, y = x.double(), y.double()
    nan = torch.isnan(x)
    if not torch.equal(nan, torch.isnan(y)):
        return float("inf")
    return float((x[~nan] - y[~nan]).abs().max()) if (~nan).any() else 0.0


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
        k1_ms, k1_ev = timed(lambda: K.bai_breen_estimate(pos, w, boxes), 50)
        k1_plain, k1p_ev = timed(
            lambda: K.bai_breen_estimate_plain(pos, w, boxes), 10)
        k2_ms, k2_ev = timed(lambda: K.bai_breen_refine(pos, w, boxes, est), 50)
        k2_plain, k2p_ev = timed(
            lambda: K.bai_breen_refine_plain(pos, w, boxes, est), 10)
        say(f"  K1 {label}: kernel {k1_ms:.4f} ms device ({k1_ev:.4f} ms "
            f"per call by events), twin {k1_plain:.4f} ms device ({k1p_ev:.4f})")
        say(f"  K2 {label}: kernel {k2_ms:.4f} ms device ({k2_ev:.4f} ms "
            f"per call by events), twin {k2_plain:.4f} ms device ({k2p_ev:.4f})")
        rec["bai_breen_estimate"] = dict(ms=k1_ms, plain_ms=k1_plain, shape=label)
        rec["bai_breen_refine"] = dict(ms=k2_ms, plain_ms=k2_plain, shape=label)

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
    k3_ms, k3_ev = timed(lambda: K.pair_reduce(pep, mem, boxes, 0.5), 20)
    k3_plain, k3p_ev = timed(lambda: K.pair_reduce_plain(pep, mem, boxes, 0.5), 3)
    say(f"  K3: kernel {k3_ms:.4f} ms device ({k3_ev:.4f} ms per call by "
        f"events), twin {k3_plain:.4f} ms device ({k3p_ev:.4f})")
    rec["pair_reduce"] = dict(ms=k3_ms, plain_ms=k3_plain, shape=k3_shape)
    rec["bai_breen_estimate"]["max_abs_err"] = k1_err
    rec["bai_breen_refine"]["max_abs_err"] = k2_err
    rec["pair_reduce"]["max_abs_err"] = e3
    return rec


def profile_pass(torch, label, fn):
    """One profiled pass: wall clock, device busy share, top device ops."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    rec = kernel_checks(dev)

    # ---- 4. main path, streamed ---------------------------------------
    say(f"phase 4: streamed main path, {N_ATOMS} atoms x {N_FRAMES} frames")
    xtc = os.path.join(K.BUILD_DIR, f"smoke_{N_ATOMS}_{N_FRAMES}.xtc")
    ok = False
    if os.path.exists(xtc):
        offs, _, _, nat = native.xtc_scan(xtc)
        ok = len(offs) == N_FRAMES and nat == N_ATOMS
    if not ok:
        t0 = time.perf_counter()
        os.makedirs(K.BUILD_DIR, exist_ok=True)
        testing.build_trajectory(xtc, N_ATOMS, N_FRAMES)
        say(f"  trajectory written in {time.perf_counter() - t0:.1f} s")
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

    # ---- 6. the kernels ran on the main path ----------------------------
    counts = dict(K.launch_counts)
    say(f"phase 6: launches during the main path {counts}")
    for k, v in counts.items():
        check(v > 0, f"{k} launched on the main path")

    # ---- 7. the observables pass at full width --------------------------
    obs_counts, orunner, odt = observables_phase(
        torch, xtc, offs, nat, c0[0], box, pipe, dev)

    # ---- where the time goes: one profiled pass of each kind -----------
    for label, fn in (
            ("streamed", lambda: runner.run(xtc, batch_size=BATCH)),
            ("resident", lambda: runner.run(dt, batch_size=BATCH)),
            ("observables resident", lambda: orunner.run(odt, batch_size=BATCH))):
        profile_pass(torch, label, fn)

    src = {"bai_breen_estimate": ("groan_rs_tpu_torch/csrc/bai_breen.cu",
                                  "groan_rs_tpu/ops/pallas_kernels.py:159"),
           "bai_breen_refine": ("groan_rs_tpu_torch/csrc/bai_breen.cu",
                                "groan_rs_tpu/ops/pallas_kernels.py:250"),
           "pair_reduce": ("groan_rs_tpu_torch/csrc/pair_reduce.cu",
                           "groan_rs_tpu/ops/pallas_kernels.py:27")}
    say(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src[k][0], "replaces": src[k][1],
         "launches": counts[k], "max_abs_err": rec[k]["max_abs_err"],
         "ms": rec[k]["ms"], "plain_ms": rec[k]["plain_ms"],
         "shape": rec[k]["shape"], "observables_launches": obs_counts[k]}
        for k in src]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
