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
   batch 12 on the runner's default wire ("auto": each batch on the
   smallest wire of the ladder delta6 -> delta -> q16 that it fits);
   checked against float64 host oracles.
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
   12, over the first `TRI_MAIN_FRAMES` (24) frames, streamed twice; against the triclinic float64 oracles (COM,
   distance, RMSD within 2e-3 on 8 frames, min distance within 1e-4 and
   contacts inside the oracle's bounds on 1); the resident passes equal
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
10. From files to results, 1M atoms, port APIs only: the synthetic system
   with real names (`testing.named_layout`) written as GRO from phase 4's
   frame 0 and read back with `System.from_file`; `guess_elements`; the
   groups Protein, Membrane, Peptide and Water from GSL queries, equal to
   the layout's ranges, through an NDX file and back; positions on frame
   0's grid points (within one float32 ulp); every mass its element's.
   The main path over phase 4's XTC split in two files (the middle frame
   in both) with a time range and a stride: the times by the dedup-and-
   stride rule (`testing.expected_frames`), COM, distance and RMSD within
   2e-3 of float64 oracles on 12 frames with the guessed masses, min
   distance within 1e-4 on 2; the single file with the same options and
   `load_device` + `run(dt)` equal within 1e-6.  A 12-frame TRR with
   seeded velocities: kinetic energy, temperature and a custom velocity
   step within rel 1e-5 of float64 host sums, COM within 2e-3, resident
   equal to streamed, the f32 wire.  K1, K2 and K3 launched; their
   launches join phases 4-5's in the kernels' line.
11. Hydrogen bonds and bond guessing, 1M atoms: `guess_bonds` on phase
   10's System equal to a float64 cKDTree oracle outside 1e-5 nm of each
   pair's limit.  Phase 7's full topology, every water as one chain
   (OW / OW / HW1 HW2, 0.35 nm, 120 degrees) beside a Protein COM:
   `method="auto"` picks cells; `HB_FRAMES` (12) frames streamed at batch
   12 over q16; the first and last equal the host float32 emulation exactly,
   `hbonds_analyze_batched` equals the host path bond for bond on frame
   0, the COM is within 2e-3 of float64, a resident window is refused,
   K1 and K2 launched (their launches join the kernels' line).  The first
   7,000 waters (a GSL serial range): `"auto"` picks dense; strict dense
   streamed and resident equal cells on every frame; the frames
   `strict=False` gets wrong are printed, with the guarded triples, the
   re-score, the scorer's and counter's device ms, the candidate and
   wire counts and `max_memory_allocated`.
12. The reference's System API, 1M atoms, on phase 10's System (guessed
   masses, GSL groups, phase 11's guessed bonds) on the card by default:
   `xtc_iter` over every frame with `group_get_com`, `group_get_center`
   and `group_distance`, equal to a runner pass on the same System within
   1e-6 and to float64 oracles within 2e-3 (12 frames);
   `calc_rmsd_and_fit` equal to the runner's RMSD within 1e-5, the fitted
   Protein's RMSD recomputed in float64 within 1e-4 on 2 frames; on frame
   0 `make_molecules_whole`, `make_group_whole`, `atoms_center`,
   `group_create_from_geometry` (a cylinder) and a sphere's
   `filter_geometry(...).get_com()` against float64 oracles (1e-4 nm,
   membership exact outside 1e-5 nm of the surface); 12 frames of the
   Protein written as XTC (back within half of 1/precision) and TRR (bit
   for bit); `traj_iter_map_reduce` (K1 + K2 COM, K3 min distance, a fold
   on the device) equal to the runner within 1e-6, and a checkpointed pass
   stopped after two batches resuming to the same carry.  K1, K2 and K3
   launch exactly as predicted; their launches join the kernels' line.
13. The conformational analyses (`models/structure.py`) and the frame
   converters, 1M atoms, on phase 10's System at frame 0 over phase 4's
   frames, each analysis loading only its group: `rmsf` (from the file,
   and `fit=False`), `rotmat`, `rmsd_matrix` and `cluster` (gromos,
   linkage, Jarvis-Patrick) on the 99,000-atom Protein; `morph` from
   frame 0 to the last (30 frames, XTC); `dssp` 3-state over 48 frames and
   8-state over 12 of all 9,900 residues; `ramachandran`; `pca`,
   `entropy`, `dccm`, the two halves' `subspace_overlap`,
   `cosine_content` and `mode_traj` (XTC) on the C-alphas of residues
   1-1,000; `rmsdist` of all 9,900 C-alphas; `mdmat` of residues 1-1,000;
   `clustsize` of the first 2,000 waters (molecules by the layout's own
   bonds: phase 11's guessed bonds join the random synthetic waters into
   molecules of thousands of atoms);
   `convert_iter` with `FitConverter` + `WrapConverter` over 12 frames
   written as XTC.  Checks against float64 host oracles
   (`testing.host_prepared` / `host_kabsch` and the others): RMSF,
   rotations and fitted RMSD within 1e-4 (atoms within 1e-5 nm of the wrap
   boundary, or their frames, excused), RMSD equal to `add_rmsd` within
   1e-5, RMSD matrix rows 0 and 47 within 1e-4, symmetric with a zero
   diagonal within 1e-5, cluster labels equal `testing.host_clusters`,
   PCA eigenvalues and the DCCM covariance within 1e-3 of the largest,
   the entropies equal to their formulas over the card's eigenvalues and,
   over the 47 modes the frames determine, within relative 1e-3 of
   float64 (the null modes' float32 noise is printed); on
   `STRUCT_ORACLE_FRAMES` frames (frame 0) the card's hydrogen bonds of a 2,000-residue band equal float64's and the
   band's 3- and 8-state codes equal `testing.host_dssp_codes` (residues
   within float32 reach of a half-box image tie excused), dihedrals
   within 2e-2 degrees (sites with a bond at a half-box tie excused),
   mdmat rows within 1e-5 nm, clustsize clusters between those of the
   cutoff -+ 1e-5 nm; rmsdist 0 at the reference frame; written XTCs back
   within half of 1/precision and two float32 ulps.  `dssp` of 20 ideal
   helices and 20 hairpins (2,000 residues) reads H and E.  K1 and K2
   launch as predicted (K3 never); `rmsf` and `rmsd_matrix` on 4 frames
   equal between the kernel path and the twin path (CPU tensors) within
   1e-4.  Its launches join the kernels' line.
14. The time-correlation and transport analyses (`models/dynamics.py`), 1M
   atoms, each from its file name: phase 7's full synthetic topology (the
   layout's own bonds) over phase 4's 48 frames and a 24-frame TRR of all
   atoms (phase 4's frames 0-23, seeded AR(1) velocities,
   `testing.ar1_velocities`). `msd` and `diffusion` (xyz, xy) of the
   200,334 water oxygens, `msd_mol` (xy) of the 6,000 lipids, `vanhove`
   of the 601,000 water atoms (lags 1-47, 2 nm, 100 shells), `rotacf` P1
   and P2 of the 200,333 OW -> HW1 vectors, `current` of all atoms,
   `vacf` (plain and mass-weighted), `dos` and `tcaf` (n_k 4) of the
   water from the TRR, `dipole_corr` total and per molecule,
   `hbond_acf` / `hbond_lifetime` of phase 11's 7,000-water chain, and
   `filter_traj` of the Protein (window 5, plain and wrapped, XTC).
   Against float64 host oracles (`testing.py`): curves within 1e-4 of
   their largest value, D, T, dof and the DOS spectrum within relative
   1e-4, TCAF curves within 1e-4 and nu, eta_k, eta0 within relative 1e-3,
   dipole ACFs within 1e-4 of corr[0]; `current`'s mj2 and conductivity
   within `testing.current_bound` (float32 rounding of the 1M-atom sum);
   Van Hove counts int64, summing to (F - lag) x 601,000 at every lag and
   equal to float64's on lags 1, 2, 23 and 47 but for norms within 1e-6
   nm of a shell edge; hydrogen bonds of frames 0 and 47 equal the host
   emulation's, the intermittent ACF equal between the two entry points;
   filtered frames read back within half of 1/precision and two ulps.
   `msd` and `vacf` over a `load_device(ship="all")` window and a
   `runner(group=...)` window equal the file calls bit for bit, and a
   window without the group raises `ParallelError`; `msd_mol` and
   `vanhove` repeat bit for bit.  K1, K2 and K3 never launch (predicted 0).
15. The membrane and interfacial-water analyses (`models/membrane.py`),
   1M atoms, each from its file name, on phase 14's topology with
   `testing.named_layout`'s residues and names, over phase 4's 48 frames:
   `densmap` of the 601,000 water atoms (xy, 100 x 100; number, mass and
   charge; its GridMap saved and read back), `potential_profile` of all
   atoms (z, 100 slabs), `order_parameters` of the Membrane (96,000 C-H
   bonds), `densorder` of the Membrane (mass, 100 slabs, threshold 0.5),
   `leaflets` of the 6,000 lipid heads (atom P), `h2order` of the 200,333
   whole waters (50 slabs), `sorient` and `spol` around the Protein's
   refined centre (rmax 1.5 nm; 40 and 50 bins), `hydorder` of the 200,333
   oxygens over frame 0 (`HYD_FRAMES`, 20 slabs).  Against float64
   oracles (`testing.py`, on threads; hydorder's over frame 0): densmap counts equal (the float32 tile rule;
   within `host_density_map`'s edge bounds), densities within 1e-5; rho,
   field and psi within 1e-4 of their largest; order within 1e-4;
   interfaces within 1e-3 nm; leaflet signs equal, thickness and centre
   within 1e-4 nm; h2order counts equal, cosines within 1e-4; sorient and
   spol histograms equal but for values within float32 reach of a bin
   edge, means within 1e-4; hydorder S_g and S_k within 1e-4 of a
   periodic cKDTree query but for 4th/5th-neighbour ties within 1e-5 nm.
   `sorient` and `hydorder` over a `load_device` window equal the file
   calls bit for bit, and repeat; `sorient` over "name OW" (a lone last
   OW) raises InvalidWater; hydorder's tie rule holds on the card; on
   phase 8's dodecahedron (12 frames) `densmap` and `sorient` against the
   triclinic oracles with no kernel launch.  K1 and K2 launch once per
   frame chunk of each `sorient` and `spol` call (3 at 48 frames), K3
   never; its launches join the kernels' line.
16. The geometric and surface analyses (`models/geometry.py`), 1M atoms,
   each from its file name, on phase 15's System with guessed elements
   (vdW radii) and +1 / -1 charges on the LYS/ARG and ASP/GLU residues:
   `sasa` of the 99,000-atom Protein (the first `GEO_FRAMES` frames, max_neighbors 128; the
   cap is shown raising just below frame 0's largest relevant count),
   `freevolume` of all atoms (8,192 probes, seed 0 and `points=`, frames
   0-3), `sdf` of the 200,334 water oxygens around the Protein (4 nm,
   40^3 voxels, number and mass, with and without the fit), `polystat` of
   the 6,000 lipids, `helixorient` of the 9,900 C-alphas and of an ideal
   alpha-helix, `bundle` of 20 segments, `dyecoupl`, `gangle` of the
   200,333 whole waters (vectors and planes against z and t0), `pairdist`
   (COM: the Protein's residues x the lipids over `GEO_FRAMES`; min: 500 x
   500 residues), `saltbr` over 1,000 residues, `select_dynamic` (waters
   within 0.35 nm of the Protein with whole residues, `GEO_FRAMES`; a
   cylinder over all frames), `trjorder` of the whole waters around the
   Protein (atom, min and com; shell 0.5 nm; `GEO_FRAMES`; an `output=` XTC
   read back), `pi_mindist` of the Peptide (48 frames) and of the Protein
   (frame 0).  Against float64 oracles (`testing.py`, on threads; over
   the analyses' frames: `GEO_FRAMES` (1 since phase 23 came) and
   `FREEVOL_FRAMES` (4), the Protein's `pi_mindist` frame 0):
   sampled SASA, free fractions and SDF voxels equal but for values within
   2e-5 nm of an edge; distances within 1e-4 nm (trjorder 1e-5, its order
   equal but between molecules within 2e-5 nm); polystat within relative
   1e-5; helix windows within `testing.host_helixorient`'s float32 bounds;
   angles' cosines within the sites' float32 reach; the periodic-image
   distances within rtol 2e-5 / atol 1e-5.  Resident windows equal the
   file calls bit for bit; on phase 8's dodecahedron `sasa`, `freevolume`,
   `select_dynamic` and `pi_mindist` against the triclinic oracles with no
   kernel launch; `chi` on ideal residues with every side-chain
   alternative (`testing.chi_state`) within 2e-2 degrees of float64.  K1
   and K2 launch once per frame chunk of each of the four `sdf` calls
   plus once each for frame 0's centre of the two fitted calls (6 at 48
   frames), K3 never; its launches join the kernels' line.
17. The scattering, free-energy and system-preparation families
   (`models/scattering.py`, `freeenergy.py`, `prep.py`), 1M atoms, on
   phase 16's System: `saxs` of the 99,000-atom Protein (60 q, frame 0
   of a byte copy) and of the 400-atom Peptide, `sans(deuterate=True)` of
   the Protein (frame 0); `dielectric` and `dielectric_spectrum` of the
   601,000 water atoms over the 48-frame XTC; `wham` (40 harmonic windows
   of 100,000 exact samples, 200 bins), `bar_intervals` (20 intervals of
   50,000 Crooks-Gaussian work samples), `lie` (10,000 frames); the gmx
   preparation chain: `insert_molecules` of 50 copies of a 20-atom chain
   into the Protein + Membrane (399,000 atoms, radius 0.21, seed 0),
   `solvate` with a seeded spc216-geometry tile (216 waters, 1.86206 nm:
   12^3 tiles), `genion` of 150 NA and 150 CL, `genconf` of the Membrane on
   2 x 2 x 1.  Against float64: the Debye sums on the card at every 10th q
   (the Protein's saxs on frame 0) and on the host at all q for the
   Peptide, within 1e-5 of the sum of |terms| (the relative error
   printed); M within 1e-4 of its largest |M|
   (per-molecule minimum image on the host), epsilon, phi and the spectrum
   within the bounds M's error gives (`testing.dielectric_bound`),
   `n_charged_molecules` exactly; WHAM within 0.1 kT of the closed form,
   BAR within 5 errors of the drawn free energies, LIE its formula; every
   inserted atom the radius from all before it, the solvate set equal to a
   periodic cKDTree's but within 1e-5 nm of the radius, ions on replaced
   waters' oxygens with the books balanced, genconf's copies shifted
   exactly and renumbered; insert_molecules and genion again give the same
   bits.  Each Debye sum's share of its FP32 bound is printed.  K1, K2 and
   K3 never launch (predicted 0); the line of kernels carries the count.
18. The host readers and writers, 1M atoms, on phase 10's System over
   phase 4's XTC: its first 24 f32 frames written through the System's
   writer registry as TNG with the XTC2 codec (its first 12 as gzip TNG),
   and by `testing.py` as DCD (with a cell) and Amber NetCDF; its first
   as a LAMMPS dump ('real' units, shuffled ids), XYZ (the registry) and
   MOL2.  The main
   path (COM, COM distance, fitted RMSD, min distance, batch 12) over each
   file against the f32-wire XTC pass over the same frames: the gzip TNG
   bit for bit, every other format within 1e-5 (nm and RMSD), more only
   as far as atoms taking another unwrap image explain; times, steps and
   boxes as each format defines them; each file deleted after its pass.
   A profiled pass (`utils/profiling.py`) with every batch in its summary
   and a `trace()` of one batch whose Chrome trace is non-empty.
   `GROAN_XTC_BACKEND=py`: frame 0 up to the runner's last atom bit for
   bit the native codec's, with its seconds.  The System to YAML and back
   equal in every column (`io/serde.py`, no PyYAML).  `ops/vecmath.py` on
   1M vectors on the card against float64 numpy.  K1 and K2 launch 4
   times and K3 once a batch of the 17 batches of its passes (68, 68, 17);
   the line of kernels carries the count.
19. Multi-device (`make_mesh`, `ops/sharded.py`, `parallel/multihost.py`)
   on the one card: `make_mesh()` (every card on the frames axis), and
   2x1, 1x4 and 2x2 meshes over the card repeated.  Phase 4's main path
   on `make_mesh()` and on 2x1 (every batch split in two frames shards)
   equals phase 4's pass: COM, distance and min distance bit for bit,
   RMSD within 2e-5; its resident re-runs on the single-device sibling
   engine, fused and not, equal that streamed pass.  The single-device,
   `make_mesh()` and 2x1 main paths are then timed in `MAIN_REPS`
   interleaved rounds (median, min, max).  The atoms-sharded
   runner with the JAX test's 12 observables (com, distance, rmsd,
   mindist, contacts, rdf, dens, gyr, gyr4, prof, dip, vol; pair
   observables the Peptide against the Membrane) on phase 7's System over
   24 frames on 1x4 and 2x2 against the single-device runner: within 5e-5
   (rtol and atol), contacts exact, the RDF within one count a bin; the
   f32 wire equal to the q16 within 1e-6; on one batch of phase 9's
   dodecahedron, the triclinic step (no density map) against the
   single-device triclinic runner.  Two processes share the card through
   a gloo group on a `file://` store: each runs phase 4's main path on
   its `with_host_shard(i, 2)` stripe, `merge_striped` gives phase 4's
   series (COM, distance, min distance bit for bit, RMSD within 2e-5);
   then rank 1 raises at its second batch and both end with
   ParallelError.  The parent has built the kernels before it spawns
   them; a process that has not ended within `MH_LIMIT` seconds is
   killed and fails the phase.  Launches as predicted in PERF.md; the
   kernels' line carries them as `sharded_launches`.
20. The command line (`groan_rs_tpu_torch/cli.py`), 1M atoms, on phase
   10's GRO and NDX over phase 4's XTC, each tool called through
   `cli.main` as a user types it, with no --device (so on the card):
   `rms` and `gyrate` of the Protein, `distance` Protein to Membrane,
   `mindist` Peptide to Membrane, and `trjconv` of the Protein centred
   over a 6-frame time window.  GRO carries no masses (the CLI reads them
   from TPR files only), so `rms` and `gyrate` guess elements after the
   read, as phase 10 does.  Each XVG equals the same call through the API
   (`TrajectoryAnalysis` on the same device, batch 32) to its 8 digits,
   the trjconv XTC the API's `convert_iter` output byte for byte; K1, K2
   and K3 each launch, as many times as in the API's calls; `mindist` once
   more through `python -m groan_rs_tpu_torch` in a process of its own,
   its XVG byte for byte the in-process one.  Each tool's seconds and
   its structure read's; the kernels' line carries `cli_launches`.
21. TPR files (`groan_rs_tpu_torch/io/tpr.py`), 1M atoms: phase 4's
   frame 0 as `testing.synthetic_tpr_system` lays it out (the layout's
   names, masses and charges by element, each protein residue bonded to
   its first atom, the Peptide by constraints, the lipid chains, the
   waters by SETTLE, the lone OW; seeded velocities) written by the test
   encoder `testing.write_tpr_system`, read by `System.from_file` with no
   device (so on the card): every field equal to the System written
   (names, residues, elements, masses, charges, bonds, molecules,
   positions and velocities bit for bit, box).  The main path on the
   TPR's masses over phase 4's XTC (COM, distance and RMSD within 2e-3 of
   float64 oracles on `TPR_ORACLE_FRAMES` frames, min distance equal to
   phase 4's bit for bit); `make_molecules_whole` moves atoms by whole
   box vectors and leaves every bond within half a box length on each
   axis; `rms`, `gyrate`, `mindist`, `dump` and `trjconv --pbc whole`
   through `cli.main -s x.tpr` with no --device, each equal to the same
   call through the API (XVGs to their 8 digits, the XTC byte for byte,
   dump's lines), launching K1-K3 as often as the API's calls.  The
   encode's, the read's and each tool's seconds; the kernels' line
   carries `tpr_launches`.
22. The rest of the public API, 1M atoms: phase 5's resident window
   through `FrameEngine.run_resident(fold=, init=, collect=)`, the fold
   summing COM, distance and RMSD over the frames and keeping the running
   minimum distance on the card; `collect=False`, then `collect=True`.
   The carry equals the same fold over the collected results on the host
   (the minimum exactly, the sums within 1e-5 relative), the collected
   results equal phase 5's `run_resident` bit for bit, and the streamed
   `FrameEngine.run(fold=)` carry of the same frames is within phase 5's
   1e-6 (the minimum) and 1e-5 relative (the sums).  The fold makes no
   host synchronisation (`torch.cuda.set_sync_debug_mode`), and the
   folded loop makes as many as the loop without the fold (the count is
   printed).  K1, K2 and K3 launch as predicted in PERF.md.  On the 1M-
   atom System: `Group.from_query_and_geometry`, `Group.union` and
   `Group.intersection` equal the System's group methods,
   `format_pdb_atom_line` over 2,000 seeded atoms equals the PDB writer's
   lines, and `prelude` holds the root's names.  The kernels' line
   carries `public_api_launches`.

23. The wires, the one-shot pass and the frame-index cache, 1M atoms:
   phase 4's runner over its XTC on each wire, q16 (the reference), the
   default "auto" and `GROAN_WIRE` pinned to delta6 and delta: each
   batch's wire (a pinned wire that steps down fails the run), the bytes
   per atom-frame, the decode seconds, the device rebuild's milliseconds
   a batch (CUDA events), the escapes a frame, two streamed passes (with
   the second's host clocks) and `load_device`, then the wires' passes
   again in turns (`WIRE_ROUNDS`, forwards and backwards); the streamed, `run_resident` and `run_resident_fused`
   results equal the q16 streamed pass within 1e-6 and every load's
   integers equal the q16 load's (`torch.equal`); "auto" must ship
   delta6 (the bench XTC's 0.01 nm noise fits it).  A Peptide pass (com and RMSD, 48
   frames) that fits `GROAN_ONESHOT_BYTES` runs one-shot in one step and
   equals the streamed pass one byte over the budget.  In a temporary
   `GROAN_INDEX_CACHE_DIR`: the XTC's scan, its first open (scan and
   save) and its cached open, in seconds.  K1, K2 and K3 launch as
   predicted in PERF.md; the kernels' line carries `wires_launches`.
   Every line of numbers carries the card's name and power limit.

Phase 7 also prints the worst of the 1M-atom dihedral sites: its error,
central bond, bend angles, lever arm, whether it crosses the box, and
one float32 ulp over the lever arm (`testing.dihedral_worst_site`);
phase 9 finds the triclinic one, and phase 16 prints it.

Every phase prints its seconds.  The last two stdout lines are the
kernels' JSON record and the result line `{"ok": true, "device":
{...}}`.  Imports nothing of JAX.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

N_ATOMS = 1_000_000
N_FRAMES = int(os.environ.get("SMOKE_FRAMES", 48))
BATCH = 12
# frames of phase 4's float64 oracles (24 before phase 21 came)
PARITY_FRAMES = min(12, N_FRAMES)
# frames the float64 oracles of phase 8's COM, distance and RMSD check
# (24 before phase 19 came: the whole smoke stays under 1000 s)
TRI_PARITY_FRAMES = min(8, N_FRAMES)
# frames of phase 8's triclinic main path (48 before phase 22 came: the
# whole smoke stays near 900 s on a fast host, under 1100 s on a slow one)
TRI_MAIN_FRAMES = min(24, N_FRAMES)
# threads of the float64 oracles (numpy releases the interpreter lock in
# its loops; the card's machine has 8 cores, idle while they run)
ORACLE_THREADS = min(8, os.cpu_count() or 1)


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
    """Print a phase's seconds and the process's peak host memory so far;
    -> the clock for the next phase."""
    import resource

    now = time.perf_counter()
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # KiB -> GiB
    say(f"phase {phase} seconds: {now - since:.1f} (host peak RSS {peak:.2f} GiB)")
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

    say(f"phase 8: triclinic main path, {N_ATOMS} atoms x {TRI_MAIN_FRAMES} frames, "
        "rhombic dodecahedron")
    xtc = triclinic_xtc(TRI_MAIN_FRAMES)
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
    out, passes, fetch_s = _streamed_passes(torch, runner, xtc)
    clocks = {k: round(sum(v), 4) for k, v in runner.engine.last_stage_seconds.items()}
    say(f"  streamed passes: {passes[0]:.4f} s (first), {passes[1]:.4f} s "
        f"= {TRI_MAIN_FRAMES / passes[1]:.2f} frames/s; host clocks of the last "
        f"{clocks}, fetch {fetch_s:.4f} s")
    for k in ("com", "dist", "rmsd", "mindist", "contacts"):
        v = out[k]
        check(v.shape[0] == TRI_MAIN_FRAMES and bool(np.isfinite(v).all()),
              f"{k}: {v.shape} {v.dtype} finite")

    w = state["mass"][:n_prot]
    coords, b9s, *_ = native.xtc_read_frames(xtc, offs[:TRI_PARITY_FRAMES], nat,
                                             stop_after=n_prot + n_mem)
    boxes = b9s.reshape(-1, 3, 3)
    t0 = time.perf_counter()
    errs = {"com": 0.0, "dist": 0.0, "rmsd": 0.0}
    for f in range(TRI_PARITY_FRAMES):
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
    say(f"  float64 oracles of com, dist, rmsd over {TRI_PARITY_FRAMES} frames in "
        f"{time.perf_counter() - t0:.1f} s")
    for k, e in errs.items():
        check(e < 2e-3, f"{k} vs triclinic float64 oracle over {TRI_PARITY_FRAMES} "
              f"frames (max err {e:.3e})")
    for f in range(1):
        p = coords[f]
        t0 = time.perf_counter()
        best, lo, hi = testing.host_pairs_triclinic(p[:min(400, n_prot)],
                                                    p[n_prot:], boxes[f], 0.4,
                                                    workers=ORACLE_THREADS)
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
        say(f"  {label}: {t:.4f} s = {TRI_MAIN_FRAMES / t:.2f} frames/s")
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
    """Phase 9 -> (launch counts, its runner, its resident window, its worst
    dihedral site: `testing.dihedral_worst_site` on the box matrices)."""
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
    errs = testing.observable_errors(out, coords, boxes, state, None, rdf_frames=1,
                                     workers=2, rdf_workers=ORACLE_THREADS)
    say(f"  triclinic float64 oracles over 2 frames (the RDF on 1) in "
        f"{time.perf_counter() - t0:.1f} s")
    for k, (e, bound) in errs.items():
        check(e <= bound, f"{k} vs triclinic float64 oracle: {e:.3e} (bound {bound:g})")
    tri_site = testing.dihedral_worst_site(out["dihedrals"][:2], coords, boxes)
    say(f"  worst triclinic dihedral: frame {tri_site['frame']}, site {tri_site['site']}, "
        f"error {tri_site['error']:.3e} deg, lever arm {tri_site['lever']:.4f} nm")

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
    return counts, runner, dt, tri_site


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
    out, passes, fetch_s = _streamed_passes(torch, runner, xtc)
    counts = dict(K.launch_counts)
    clocks = {k: round(sum(v), 4) for k, v in runner.engine.last_stage_seconds.items()}
    say(f"  streamed passes: {passes[0]:.4f} s (first), {passes[1]:.4f} s "
        f"= {N_FRAMES / passes[1]:.2f} frames/s; host clocks of the last "
        f"{clocks}, fetch {fetch_s:.4f} s; wires "
        f"{runner.engine.last_wires}")
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
    errs = testing.observable_errors(out, coords, b9s[:, [0, 4, 8]], state, cyl,
                                     workers=2, rdf_workers=ORACLE_THREADS)
    say(f"  float64 oracles over 2 frames in {time.perf_counter() - t0:.1f} s")
    for k, (e, bound) in errs.items():
        check(e <= bound, f"{k} vs float64 oracle: {e:.3e} (bound {bound:g})")
    site = testing.dihedral_worst_site(out["dihedrals"][:2], coords, b9s[:, [0, 4, 8]])
    say(f"  worst dihedral: frame {site['frame']}, site {site['site']} of "
        f"{out['dihedrals'].shape[1]} (atoms {site['atoms']}), error "
        f"{site['error']:.3e} deg, central bond {site['central_bond']:.4f} nm, bends "
        f"{site['bends'][0]:.3f} / {site['bends'][1]:.3f} deg, lever arm "
        f"{site['lever']:.4f} nm, crosses the box: {site['crosses_box']}; one "
        f"float32 ulp over the lever arm = {site['f32_scale']:.3e} deg")

    t0 = time.perf_counter()
    dt = runner.load_device(xtc, batch_size=BATCH)
    torch.cuda.synchronize()
    say(f"  load_device {time.perf_counter() - t0:.4f} s, resident "
        f"{dt.nbytes / 1e6:.1f} MB ({dt.kind}, {dt.n_frames} frames)")
    # every result here is deterministic on the card: integer counts are
    # exact under atomics, and the float density profiles accumulate
    # with index_put_(accumulate=True), which sums each bin in a fixed
    # (sorted) order
    resident = {}
    for label, fn in (("run_resident_fused", runner.engine.run_resident_fused),
                      ("run_resident", runner.engine.run_resident)):
        res = resident[label] = fn(dt, batch_size=BATCH)
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


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def _same(a, b, keys):
    return max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in keys)


def structure_checks(xtc, offs, nat, box):
    """Phase 10, steps 1-2: write the named synthetic system as GRO, build
    the System from the file, guess its elements, make its groups by GSL
    queries and take them through an NDX file -> (System, seconds)."""
    import warnings

    from groan_rs_tpu_torch import System, testing
    from groan_rs_tpu_torch.core.elements import Elements
    from groan_rs_tpu_torch.core.simbox import SimBox
    from groan_rs_tpu_torch.core.topology import Topology
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.ops import kernels as K

    secs = {}
    frame0 = native.xtc_read_frames(xtc, offs[:1], nat)[0][0]
    names = testing.named_layout(nat)
    lay = testing.synthetic_layout(nat)
    topo = Topology.from_columns(names["resnum"], names["resname"], names["atomname"],
                                 np.arange(1, nat + 1))
    gro = os.path.join(K.BUILD_DIR, f"smoke_{nat}.gro")
    t0 = time.perf_counter()
    System("synthetic membrane protein", topo, SimBox.from_lengths(*map(float, box)),
           positions=frame0).write_gro(gro)
    secs["GRO write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    system = System.from_file(gro)
    secs["GRO read"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        system.guess_elements()
    secs["guess_elements"] = time.perf_counter() - t0
    check(not caught, f"guess_elements: every atom matched one element ({len(caught)} "
          "warnings)")
    queries = {"Protein": "@protein", "Membrane": "@membrane",
               "Peptide": "Protein and serial 1 to 400", "Water": "@water"}
    t0 = time.perf_counter()
    for name, query in queries.items():
        system.group_create(name, query)
    secs["GSL groups"] = time.perf_counter() - t0
    ranges = {"Protein": (0, lay["n_prot"]), "Membrane": (lay["n_prot"], lay["w0"]),
              "Peptide": (0, min(400, lay["n_prot"])), "Water": (lay["w0"], nat)}
    for name, (a, b) in ranges.items():
        check(np.array_equal(system.group_indices(name), np.arange(a, b)),
              f"group_create('{name}', '{queries[name]}') is atoms {a}..{b - 1}")
    ndx = os.path.join(K.BUILD_DIR, f"smoke_{nat}.ndx")
    t0 = time.perf_counter()
    system.write_ndx(ndx)
    secs["NDX write"] = time.perf_counter() - t0
    second = System.from_file(gro)
    t0 = time.perf_counter()
    second.read_ndx(ndx)
    secs["NDX read"] = time.perf_counter() - t0
    check(all(np.array_equal(second.group_indices(g), system.group_indices(g))
              for g in queries), "the NDX round trip gives equal groups")
    grid = np.array_equal(np.rint(system.positions.astype(np.float64) * 1000),
                          np.rint(frame0.astype(np.float64) * 1000))
    gap = float(np.abs(system.positions - frame0).max())
    check(grid and gap <= float(np.spacing(np.float32(box.max()))),
          f"GRO positions are XTC frame 0's grid points (max diff {gap:.2e} nm, "
          "one float32 ulp)")
    sym = np.asarray(system.topology.element_symbol.values(), str)
    check(np.array_equal(sym, names["element"]), "element symbols follow the names")
    table = Elements.default()
    el = system.topology.element_name
    want = np.asarray([table.get(c).mass if c else np.nan for c in el.categories],
                      np.float32)[el.codes]
    check(bool(system.topology.has_mass.all()) and np.array_equal(system.topology.mass, want),
          f"every atom has its element's mass ({len(el.categories)} elements)")
    return system, secs


def files_phase(torch, xtc, offs, nat, box, dev):
    """Phase 10 -> K1/K2/K3 launches of its passes."""
    from groan_rs_tpu_torch import testing
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.models import TrajectoryAnalysis
    from groan_rs_tpu_torch.ops import kernels as K

    say(f"phase 10: from files to results, {nat} atoms")
    system, secs = structure_checks(xtc, offs, nat, box)
    say("  seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    lay = testing.synthetic_layout(nat)
    n_prot, n_mem, w0 = lay["n_prot"], lay["n_mem"], lay["w0"]
    w = system.topology.mass[:n_prot]

    # ---- two files with a duplicated boundary frame ----------------------
    t0 = time.perf_counter()
    half = N_FRAMES // 2
    parts = [os.path.join(K.BUILD_DIR, f"smoke_{nat}_part{i}.xtc") for i in (0, 1)]
    for p in parts:
        if os.path.exists(p):
            os.unlink(p)
    _, steps, times, _ = native.xtc_scan(xtc)
    for lo in range(0, N_FRAMES, BATCH):
        ids = np.arange(lo, min(lo + BATCH, N_FRAMES))
        c, b9, _, _, prec = native.xtc_read_frames(xtc, offs[ids], nat)
        for k, f in enumerate(ids):
            for p in ([parts[0]] if f <= half else []) + ([parts[1]] if f >= half else []):
                native.xtc_write_frame(p, nat, int(steps[f]), float(times[f]), b9[k],
                                       c[k], float(prec[k]))
    file_times = [native.xtc_scan(p)[2] for p in parts]
    check([len(t) for t in file_times] == [half + 1, N_FRAMES - half],
          f"split into {half + 1} + {N_FRAMES - half} frames, frame {half} in both "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- the main path over both files, a time range and a stride --------
    # frames 4, 6, .., 44: the first batch of 12 straddles the two files
    opts = {"start_time": float(times[4]) - 5.0,
            "end_time": float(times[N_FRAMES - 3]) + 5.0, "step": 2}
    pipe = (TrajectoryAnalysis(system, device=dev)
            .add_com("Protein", name="com")
            .add_distance("Protein", "Membrane", com=(True, False), name="dist")
            .add_rmsd("Protein", reference=system, name="rmsd")
            .add_min_distance("Peptide", "Membrane", name="mindist"))
    runner = pipe.runner()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = runner.run(parts, batch_size=BATCH, **opts)
    torch.cuda.synchronize()
    t_cat = time.perf_counter() - t0
    fi, fr = testing.expected_frames(file_times, **opts)
    frames = np.where(fi == 0, fr, fr + half)  # frame numbers of the source XTC
    check(np.array_equal(out["times"], times[frames]) and
          np.array_equal(out["steps"], steps[frames]),
          f"{len(frames)} frames {frames[0]}, {frames[1]}, .., {frames[-1]}: the "
          f"dedup-and-stride rule (streamed {t_cat:.2f} s)")
    sel = frames[:BATCH]
    coords, b9s, *_ = native.xtc_read_frames(xtc, offs[sel], nat, stop_after=w0)
    p0 = system.positions[:n_prot]
    ref_com0 = testing.host_refined_center(p0, box, w)
    box64 = np.asarray(box, np.float64)
    ref = np.mod(p0 + (box64 / 2 - ref_com0), box64) - box64 / 2
    com_h, dist_h, rmsd_h = [], [], []
    for p in coords:
        ca = testing.host_refined_center(p[:n_prot], box, w)
        cb = testing.host_refined_center(p[n_prot:w0], box)
        d = ca - cb
        d -= box64 * np.round(d / box64)
        com_h.append(ca)
        dist_h.append(np.sqrt((d * d).sum()))
        rmsd_h.append(testing.host_kabsch_rmsd(ref, np.zeros(3), p[:n_prot], box, w))
    k = len(sel)
    for key, want in (("com", com_h), ("dist", dist_h), ("rmsd", rmsd_h)):
        e = float(np.abs(out[key][:k] - np.asarray(want)).max())
        check(e < 2e-3, f"{key} vs float64 oracle over {k} frames, guessed masses "
              f"(max err {e:.3e})")
    for f in range(2):
        want = testing.host_min_distance(coords[f][:min(400, n_prot)],
                                         coords[f][n_prot:w0], box)
        e = abs(float(out["mindist"][f]) - want)
        check(e < 1e-4, f"mindist frame {sel[f]} vs float64 oracle "
              f"({out['mindist'][f]:.6f} vs {want:.6f})")
    keys = ("com", "dist", "rmsd", "mindist")
    single = runner.run(xtc, batch_size=BATCH, **opts)
    e = _same(single, out, keys)
    check(np.array_equal(single["times"], out["times"]) and e <= 1e-6,
          f"the single file with the same options equals the two (max diff {e:.1e})")
    t0 = time.perf_counter()
    dt = runner.load_device(parts, batch_size=BATCH, **opts)
    res = runner.run(dt, batch_size=BATCH)
    torch.cuda.synchronize()
    e = _same(res, out, keys)
    check(dt.n_frames == len(frames) and e <= 1e-6,
          f"load_device with the same options, then run(dt), equals the streamed "
          f"pass (max diff {e:.1e}; {dt.kind}, {time.perf_counter() - t0:.2f} s)")
    check(dt.kind == "f32", "a batch straddles the two files: the window is f32")
    counts = dict(K.launch_counts)  # the three passes over the XTC files

    # ---- TRR: positions and velocities -----------------------------------
    t0 = time.perf_counter()
    n_trr = BATCH
    trr = os.path.join(K.BUILD_DIR, f"smoke_{nat}_{n_trr}.trr")
    if os.path.exists(trr):
        os.unlink(trr)
    x, b9, *_ = native.xtc_read_frames(xtc, offs[:n_trr], nat)
    v = (np.random.default_rng(17).normal(size=x.shape) * 0.4).astype(np.float32)
    for f in range(n_trr):
        native.trr_write_frame(trr, nat, int(steps[f]), float(times[f]), 0.0, b9[f],
                               x=x[f], v=v[f])
    say(f"  TRR of {n_trr} frames written in {time.perf_counter() - t0:.1f} s "
        f"({os.path.getsize(trr) / 1e6:.0f} MB)")
    mem = slice(n_prot, w0)

    def membrane_v2(pos, vel, boxes, mask):  # every atom ships: global indices
        return (vel[:, mem] * vel[:, mem]).sum((1, 2))

    vpipe = (TrajectoryAnalysis(system, device=dev)
             .add_com("Protein", name="com")
             .add_kinetic_energy("Protein", name="ke")
             .add_temperature("Water", name="temp")
             .add_velocity_step("membrane_v2", membrane_v2, touches="Membrane"))
    vrunner = vpipe.runner()
    check(vrunner.sel is None, "the velocity pass ships every atom (water is touched)")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    vout = vrunner.run(trr, batch_size=BATCH)
    torch.cuda.synchronize()
    t_trr = time.perf_counter() - t0
    m = system.topology.mass
    n_wat = nat - w0
    for key, want in (
            ("ke", testing.host_kinetic(v[:, :n_prot], m[:n_prot])),
            ("temp", 2 * testing.host_kinetic(v[:, w0:], m[w0:]) / (3 * n_wat * testing.KB)),
            ("membrane_v2", (v[:, mem].astype(np.float64) ** 2).sum((1, 2)))):
        e = _rel(vout[key], want)
        check(vout[key].shape == (n_trr,) and e < 1e-5,
              f"{key} vs float64 host sum (rel {e:.2e}; streamed {t_trr:.2f} s)")
    for f in range(4):
        e = float(np.abs(vout["com"][f] - testing.host_refined_center(
            x[f][:n_prot], box, w)).max())
        check(e < 2e-3, f"TRR com frame {f} vs float64 oracle ({e:.3e})")
    vdt = vrunner.load_device(trr, batch_size=BATCH)
    vres = vrunner.run(vdt, batch_size=BATCH)
    e = _same(vres, vout, ("com", "ke", "temp", "membrane_v2"))
    check(vdt.kind == "f32" and vdt.aux_names == ("vel",) and e <= 1e-6,
          f"resident velocity pass equals streamed (max diff {e:.1e}; the wire "
          f"is {vdt.kind})")
    trr_counts = dict(K.launch_counts)
    for k2 in ("bai_breen_estimate", "bai_breen_refine"):
        check(trr_counts[k2] > 0, f"{k2} launched on the TRR pass")
    counts = {k2: v2 + trr_counts[k2] for k2, v2 in counts.items()}
    for k2, v2 in counts.items():
        check(v2 > 0, f"{k2} launched in phase 10 ({v2})")
    for p in parts + [trr]:
        os.unlink(p)
    return counts, system


HB_FRAMES = 12  # frames of phase 4's XTC in the hydrogen-bond passes (24 before phase 22)
DENSE_WATERS = 7000  # waters of the dense chain: 4.9e7 pairs per leg


def guess_bonds_checks(system, box):
    """Phase 11 (a): `guess_bonds` on phase 10's System against a float64
    cKDTree with the box as its period: equal bond sets outside 1e-5 nm of
    each pair's limit 0.55 (vdw_i + vdw_j)."""
    import warnings

    from scipy.spatial import cKDTree

    from groan_rs_tpu_torch.system.guess import DEFAULT_RADIUS_FACTOR as F

    topo = system.topology
    n = system.get_n_atoms()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        system.guess_bonds()
    t_guess = time.perf_counter() - t0
    got = topo.bond_pairs()
    box64 = np.asarray(box, np.float64)
    p = np.mod(system.positions.astype(np.float64), box64)
    p = np.where(p >= box64, 0.0, p)
    vdw = topo.vdw.astype(np.float64)
    t0 = time.perf_counter()
    cand = cKDTree(p, boxsize=box64).query_pairs(
        2 * F * float(vdw[topo.has_vdw].max()), output_type="ndarray")
    i, j = cand[:, 0], cand[:, 1]
    keep = topo.has_vdw[i] & topo.has_vdw[j]
    i, j = i[keep], j[keep]
    d = p[i] - p[j]
    d -= box64 * np.round(d / box64)
    dist = np.sqrt((d * d).sum(1))
    lim = F * (vdw[i] + vdw[j])
    t_tree = time.perf_counter() - t0
    key = i.astype(np.int64) * n + j
    band = key[np.abs(dist - lim) < 1e-5]
    diff = np.setxor1d(got[:, 0] * n + got[:, 1], key[dist < lim])
    say(f"  guess_bonds at {n} atoms: {t_guess:.2f} s, {len(got)} bonds; cKDTree "
        f"oracle {t_tree:.2f} s, {int((dist < lim).sum())} bonds; {len(band)} pairs "
        f"within 1e-5 nm of their limit, {len(diff)} bonds differ; warnings "
        f"{[str(w.message) for w in caught]}")
    check(np.isin(diff, band).all(),
          "guess_bonds equals the float64 cKDTree oracle outside 1e-5 nm of each limit")
    return t_guess


def _bond_arrays(bonds):
    """(int64 [k, 3] donor/hydrogen/acceptor, float64 distances, cosines)."""
    idx = np.asarray([(b.donor, b.hydrogen, b.acceptor) for b in bonds], np.int64)
    dist = np.asarray([b.distance for b in bonds], np.float64)
    cos = np.cos(np.radians(np.asarray([b.angle for b in bonds], np.float64)))
    return idx.reshape(-1, 3), dist, cos


def cell_stats(batch_stats):
    """One line per batch of the cell scorer's record."""
    for k, s in enumerate(batch_stats):
        dev_ms = "not measured" if s["device_ms"] is None else f"{s['device_ms']:.3f} ms"
        say(f"    batch {k}: candidate pairs per frame {int(s['candidates'].mean())}, "
            f"host candidates {s['host_candidate_s']:.3f} s (C++ walk "
            f"{s['walk_s']:.3f} s), wire "
            f"{s['wire_bytes'] / 1e6:.1f} MB, scorer device {dev_ms}, guarded "
            f"triples per frame mean {s['guarded'].mean():.1f} max "
            f"{int(s['guarded'].max())}, host re-score {s['rescore_s']:.4f} s")


def hbonds_phase(torch, xtc, offs, nat, frame0, box, fsys, dev):
    """Phase 11 -> K1/K2/K3 launches of its cell pass (with a COM)."""
    from groan_rs_tpu_torch import convert, testing
    from groan_rs_tpu_torch.core.simbox import SimBox
    from groan_rs_tpu_torch.errors import ParallelError
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.models import TrajectoryAnalysis
    from groan_rs_tpu_torch.ops import kernels as K
    from groan_rs_tpu_torch.system.hbonds import HBondAnalysis, HBondChain

    say(f"phase 11: hydrogen bonds and bond guessing, {nat} atoms")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    guess_bonds_checks(fsys, box)

    # ---- (b) the cell method over every water ---------------------------
    _, _, times, _ = native.xtc_scan(xtc)
    n_hb = min(HB_FRAMES, len(times))
    end = float(times[n_hb - 1])
    state = testing.synthetic_state(frame0.copy(), box, topology="full")
    system = convert.system_from_state(state)
    lay = testing.synthetic_layout(nat)
    n_prot, w0 = lay["n_prot"], lay["w0"]
    water = [HBondChain("name OW", "name OW", "name HW1 HW2")]
    pipe = (TrajectoryAnalysis(system, device=dev)
            .add_hbonds(water, [(0, 0)], 0.35, 120.0, name="hb")
            .add_com("Protein", name="com"))
    n_don = len(lay["water_oxygens"])
    check(len(pipe._hbond_specs) == 1 and not pipe._multi_factories,
          f"method='auto' picked cells ({n_don} x {n_don} = {n_don ** 2:.1e} pairs per leg)")
    runner = pipe.runner()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = runner.run(xtc, batch_size=BATCH, end_time=end)
    if cuda:
        torch.cuda.synchronize()
    t_cells = time.perf_counter() - t0
    counts = dict(K.launch_counts)
    hb = out["hb_0_0"]
    clocks = {k: round(sum(v), 3) for k, v in runner.engine.last_stage_seconds.items()}
    say(f"  cell pass, {n_hb} frames streamed at batch {BATCH}, q16, {len(runner.sel)} "
        f"atoms shipped: {t_cells:.2f} s; host clocks {clocks}; launches {counts}")
    say(f"  hydrogen bonds per frame: {hb.tolist()}")
    cell_stats(runner.hbond_specs[0][1].batch_stats)
    check(hb.shape == (n_hb,) and hb.dtype == np.int64 and (hb > 0).all(),
          f"hb_0_0: {hb.shape} int64, every frame has bonds")
    for k in ("bai_breen_estimate", "bai_breen_refine"):
        check(counts[k] > 0, f"{k} launched beside the hydrogen bonds")

    host_ana = HBondAnalysis(system, water, [(0, 0)], 0.35, 120.0)
    ids = [0, n_hb - 1]
    coords, b9s, *_ = native.xtc_read_frames(xtc, offs[ids], nat)
    host = {}
    for k, f in enumerate(ids):
        system.positions[:] = coords[k]
        system.set_box(SimBox.from_lengths(*map(float, b9s[k][[0, 4, 8]])))
        t0 = time.perf_counter()
        host[f] = host_ana.analyze(system)[(0, 0)]
        check(len(host[f]) == hb[f], f"frame {f}: {hb[f]} bonds, the host float32 "
              f"emulation's exactly ({time.perf_counter() - t0:.2f} s on the host)")
    t0 = time.perf_counter()
    _, hmap = next(system.hbonds_analyze_batched(xtc, water, [(0, 0)], 0.35, 120.0,
                                                 batch_size=1, end_time=0.0, device=dev))
    t_list = time.perf_counter() - t0
    (gi, gd, gc), (hi, hd, hc) = _bond_arrays(hmap[(0, 0)]), _bond_arrays(host[0])
    same = gi.shape == hi.shape and np.array_equal(gi, hi)
    check(same and np.abs(gd - hd).max() < 1e-6 and np.abs(gc - hc).max() < 2e-6,
          f"hbonds_analyze_batched frame 0 equals the host path bond for bond "
          f"({len(gi)} bonds; distance {np.abs(gd - hd).max():.1e} nm, cos "
          f"{np.abs(gc - hc).max():.1e}; {t_list:.2f} s)")
    pc, _, *_ = native.xtc_read_frames(xtc, offs[:n_hb], nat, stop_after=n_prot)
    w = state["mass"][:n_prot]
    e = max(float(np.abs(out["com"][f] - testing.host_refined_center(pc[f], box, w)).max())
            for f in range(n_hb))
    check(e < 2e-3, f"com beside the hydrogen bonds vs float64 oracle ({e:.3e})")
    dt = runner.load_device(xtc, batch_size=BATCH, end_time=float(times[BATCH - 1]))
    try:
        runner.run(dt, batch_size=BATCH)
        refused = False
    except ParallelError:
        refused = True
    check(refused, "run(dt) with a cell spec on a resident window raises ParallelError")
    del dt

    # ---- (c) the dense method, strict, on the first waters ---------------
    n_dense = min(DENSE_WATERS, len(lay["water_oxygens"]) - 1)
    span = f"serial {w0 + 1} to {w0 + 3 * n_dense}"
    chain = [HBondChain(f"name OW and {span}", f"name OW and {span}",
                        f"name HW1 HW2 and {span}")]

    def dense_pass(method, strict=True):
        p = TrajectoryAnalysis(system, device=dev).add_hbonds(
            chain, [(0, 0)], 0.35, 120.0, name="hb", method=method, strict=strict)
        return p, p.runner()

    dpipe, drun = dense_pass("auto")
    check(len(dpipe._multi_factories) == 1 and not dpipe._hbond_specs,
          f"method='auto' picked dense ({n_dense ** 2:.1e} pairs per leg)")
    t0 = time.perf_counter()
    dense = drun.run(xtc, batch_size=BATCH, end_time=end)["hb_0_0"]
    if cuda:
        torch.cuda.synchronize()
    t_dense = time.perf_counter() - t0
    guards, t_re = drun.last_guards["hb"], drun.last_rescore_seconds.get("hb", 0.0)
    counter = dpipe.dense_counters["hb"]
    dense_ms = [a.elapsed_time(b) for a, b in counter.events]
    ddt = drun.load_device(xtc, batch_size=BATCH, end_time=end)
    t0 = time.perf_counter()
    resident = drun.run(ddt, batch_size=BATCH)["hb_0_0"]
    if cuda:
        torch.cuda.synchronize()
    t_res = time.perf_counter() - t0
    rguards = drun.last_guards["hb"]
    _, crun = dense_pass("cells")
    t0 = time.perf_counter()
    cells = crun.run(xtc, batch_size=BATCH, end_time=end)["hb_0_0"]
    t_dcells = time.perf_counter() - t0
    _, lrun = dense_pass("dense", strict=False)
    loose = lrun.run(xtc, batch_size=BATCH, end_time=end)["hb_0_0"]
    say(f"  dense chain: {n_dense} waters ({span}), {n_hb} frames: streamed "
        f"{t_dense:.2f} s, dense counter device ms per batch "
        f"{[round(x, 3) for x in dense_ms]}; guarded triples per frame mean "
        f"{guards.mean():.1f} max {int(guards.max())}; {int((guards > 0).sum())} of "
        f"{n_hb} frames re-scored in {t_re:.3f} s; resident {t_res:.2f} s "
        f"({int((rguards > 0).sum())} frames re-scored); cells on the chain "
        f"{t_dcells:.2f} s")
    cell_stats(crun.hbond_specs[0][1].batch_stats)
    say(f"  hydrogen bonds per frame (dense chain): {dense.tolist()}")
    check(np.array_equal(dense, cells), "strict dense (streamed) equals cells on every frame")
    check(np.array_equal(resident, dense),
          "strict dense resident equals streamed bit for bit")
    wrong = int((loose != cells).sum())
    say(f"  strict=False: {wrong} of {n_hb} frames differ from the exact counts "
        f"(by {np.abs(loose - cells).tolist()})")
    if cuda:
        say(f"  max_memory_allocated over phase 11: "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    return counts


def _wrap64(x, box):
    """Float64 `wrap` with the reference's loop semantics (x == kL, k >= 1,
    stays at L)."""
    L = np.asarray(box, np.float64)
    m = np.mod(x, L)
    return np.where((m == 0) & (x > 0), L, m)


def _unwrap64(ref, p, box):
    """Float64 `vector_to` placement of `p` around `ref` (rows or one
    point) -> (positions, distance of each coordinate from its image
    boundary)."""
    L = np.asarray(box, np.float64)
    d = np.mod(np.asarray(p, np.float64) - ref + L / 2, L)
    return ref + d - L / 2, np.minimum(d, L - d)


def _near_check(got, want, edge, what, tol=1e-4):
    """Positions within `tol`, except coordinates within 1e-5 nm of an
    image boundary (float32 and float64 may put those a box apart)."""
    bad = np.abs(np.asarray(got, np.float64) - want) > tol
    excused = bad & (edge < 1e-5)
    check(not (bad & ~excused).any(),
          f"{what} equals the float64 oracle within {tol} nm ({int(excused.sum())} "
          f"coordinates within 1e-5 nm of an image boundary excused; max err "
          f"{np.abs(np.where(excused, 0, got - want)).max():.2e})")


def system_api_phase(torch, xtc, offs, nat, box, system, dev):
    """Phase 12: the reference's System API at 1M atoms on phase 10's
    System (guessed masses, GSL groups, phase 11's guessed bonds) -> the
    K1/K2/K3 launches of its calls."""
    from groan_rs_tpu_torch import testing
    from groan_rs_tpu_torch.core.dimension import Dimension
    from groan_rs_tpu_torch.core.shapes import Cylinder, Sphere
    from groan_rs_tpu_torch.errors import ParallelError
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.models import TrajectoryAnalysis
    from groan_rs_tpu_torch.ops import center as C
    from groan_rs_tpu_torch.ops import distances as D
    from groan_rs_tpu_torch.ops import kernels as K

    say(f"phase 12: the System API, {nat} atoms x {N_FRAMES} frames")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    check(system.device == dev, f"the System computes on {system.device} by default")
    lay = testing.synthetic_layout(nat)
    n_prot, w0 = lay["n_prot"], lay["w0"]
    w = system.topology.mass[:n_prot]
    ref = system.copy()  # frame 0 (the GRO's grid points): the RMSD reference
    ref_com = ref.group_get_com("Protein")
    box64 = np.asarray(box, np.float64)
    _, steps, times, _ = native.xtc_scan(xtc)

    # what the per-call path must reproduce: the runner over the same
    # System, the same kernels on the same float32 inputs
    want = (TrajectoryAnalysis(system, device=dev)
            .add_com("Protein", name="com").add_center("Membrane", name="cog")
            .add_distance("Protein", "Membrane", name="dist")
            .add_rmsd("Protein", reference=ref, name="rmsd")
            .add_min_distance("Peptide", "Membrane", name="mindist")
            .runner().run(xtc, batch_size=BATCH))

    K.reset_launch_counts()
    t_phase = time.perf_counter()

    # ---- the per-frame loop ------------------------------------------------
    com, cog, dist, lat = [], [], [], []
    t0 = time.perf_counter()
    for s in system.xtc_iter(xtc):
        t1 = time.perf_counter()
        com.append(s.group_get_com("Protein"))
        lat.append(time.perf_counter() - t1)
        cog.append(s.group_get_center("Membrane"))
        dist.append(s.group_distance("Protein", "Membrane", Dimension.XYZ))
    t_loop = time.perf_counter() - t0
    com, cog, dist = np.asarray(com), np.asarray(cog), np.asarray(dist)
    check(com.shape == (N_FRAMES, 3) and np.isfinite(com).all(),
          f"xtc_iter: {N_FRAMES} frames in {t_loop:.2f} s, group_get_com median "
          f"{1e3 * np.median(lat):.3f} ms a call on the card")
    for key, got in (("com", com), ("cog", cog), ("dist", dist)):
        e = float(np.abs(got - want[key]).max())
        check(e <= 1e-6, f"per-frame {key} equals the runner's (max diff {e:.1e})")
    n_or = min(12, N_FRAMES)
    coords, *_ = native.xtc_read_frames(xtc, offs[:n_or], nat, stop_after=w0)
    # float64 oracles: the COM (the guessed masses), the membrane's centre
    # and the distance between the two centres of geometry
    errs = {"com": 0.0, "cog": 0.0, "dist": 0.0}
    for f in range(n_or):
        ca = testing.host_refined_center(coords[f][:n_prot], box, w)
        cb = testing.host_refined_center(coords[f][n_prot:w0], box)
        d = testing.host_refined_center(coords[f][:n_prot], box) - cb
        d -= box64 * np.round(d / box64)
        for key, e in (("com", np.abs(com[f] - ca).max()), ("cog", np.abs(cog[f] - cb).max()),
                       ("dist", abs(dist[f] - np.sqrt((d * d).sum())))):
            errs[key] = max(errs[key], float(e))
    check(max(errs.values()) < 2e-3, f"com, cog and distance vs float64 oracles over "
          f"{n_or} frames (max err {errs})")

    # ---- the fitting iterator --------------------------------------------------
    t0 = time.perf_counter()
    rmsd, fitted = [], {}
    for k, (s, r) in enumerate(system.xtc_iter(xtc).calc_rmsd_and_fit(ref, "Protein")):
        rmsd.append(r)
        if k < 2:
            fitted[k] = s.positions[:n_prot].copy()
    t_fit = time.perf_counter() - t0
    e = float(np.abs(np.asarray(rmsd) - want["rmsd"]).max())
    check(len(rmsd) == N_FRAMES and e <= 1e-5,
          f"calc_rmsd_and_fit: {N_FRAMES} frames in {t_fit:.2f} s = "
          f"{N_FRAMES / t_fit:.2f} frames/s; RMSD equals the runner's (max diff {e:.1e})")
    half = box64 / 2
    ref_prep = _wrap64(ref.positions[:n_prot] + (half - ref_com), box)
    for k, pos in fitted.items():
        dev64 = (pos.astype(np.float64) - ref_com) - (ref_prep - half)
        r64 = float(np.sqrt((w * (dev64 ** 2).sum(1)).sum() / w.astype(np.float64).sum()))
        check(abs(r64 - rmsd[k]) < 1e-4, f"frame {k}: the fitted Protein's RMSD to the "
              f"reference in float64 {r64:.6f} vs {rmsd[k]:.6f}")

    # ---- modifying methods on frame 0 ------------------------------------------
    next(iter(system.xtc_iter(xtc, end_time=float(times[0]))))
    p0 = system.positions.astype(np.float64)
    t0 = time.perf_counter()
    system.make_molecules_whole()
    t_whole = time.perf_counter() - t0
    mol, refs = system.topology.molecule_ids(), system.topology.mol_references()
    ref_pos = _wrap64(p0[refs], box)[mol]
    want_pos, edge = _unwrap64(ref_pos, p0, box)
    _near_check(system.positions, want_pos, edge,
                f"make_molecules_whole ({int(mol.max()) + 1} molecules, {t_whole:.2f} s)")
    p1 = system.positions.astype(np.float64)
    est = system.group_estimate_center("Protein").astype(np.float64)
    system.make_group_whole("Protein")
    want_prot, edge = _unwrap64(est, p1[:n_prot], box)
    _near_check(system.positions[:n_prot], want_prot, edge, "make_group_whole('Protein')")
    est2 = system.group_estimate_center("Protein")
    p2 = system.positions.astype(np.float64)
    system.atoms_center("Protein", Dimension.XYZ)
    shifted = p2 + (system.get_box_center() - est2).astype(np.float64)
    _near_check(system.positions, _wrap64(shifted, box),
                np.minimum(np.abs(shifted - np.round(shifted / box64) * box64), box64),
                "atoms_center('Protein', XYZ)")
    cyl = Cylinder(system.get_box_center(), 4.0, float(box[2]), Dimension.Z)
    t0 = time.perf_counter()
    system.group_create_from_geometry("Core", "all", cyl)
    t_geo = time.perf_counter() - t0
    p3 = system.positions.astype(np.float64)
    dxy = p3[:, :2] - box64[:2] / 2
    dxy -= box64[:2] * np.round(dxy / box64[:2])
    margin = 4.0 - np.sqrt((dxy ** 2).sum(1))
    got = system.group_mask("Core")
    far = np.abs(margin) > 1e-5
    check(np.array_equal(got[far], margin[far] > 0),
          f"group_create_from_geometry(cylinder r 4 nm): {int(got.sum())} atoms "
          f"({t_geo:.2f} s), exact outside 1e-5 nm of the surface "
          f"({int((~far).sum())} atoms within it)")
    sphere = Sphere(system.get_box_center(), 5.0)
    it = system.group_iter("Membrane").filter_geometry(sphere)
    sel = it.indices
    d3 = p3[n_prot:w0] - box64 / 2
    d3 -= box64 * np.round(d3 / box64)
    m3 = 5.0 - np.sqrt((d3 ** 2).sum(1))
    far3 = np.abs(m3) > 1e-5
    in3 = np.isin(np.arange(n_prot, w0), sel)
    check(np.array_equal(in3[far3], m3[far3] > 0),
          f"group_iter('Membrane').filter_geometry(sphere r 5 nm): {len(sel)} atoms, "
          "exact outside 1e-5 nm of the surface")
    fcom = it.get_com()
    e = float(np.abs(fcom - testing.host_refined_center(
        system.positions[sel], box, system.topology.mass[sel])).max())
    check(e < 1e-4, f"its get_com vs float64 oracle ({e:.2e})")

    # ---- the writers ---------------------------------------------------------
    n_w = min(BATCH, N_FRAMES)
    paths = [os.path.join(K.BUILD_DIR, f"smoke_api_protein.{x}") for x in ("xtc", "trr")]
    t0 = time.perf_counter()
    system.group_traj_writer_init("Protein", paths[0])
    system.trr_group_writer_init("Protein", paths[1])
    written = []
    for s in system.xtc_iter(xtc, end_time=float(times[n_w - 1])):
        s.traj_write_frame()
        written.append(s.positions[:n_prot].copy())
    system.traj_close()
    t_write = time.perf_counter() - t0
    prot = system.group_extract("Protein")
    back = [s.positions.copy() for s in prot.xtc_iter(paths[0])]
    gap = max(float(np.abs(b - a).max()) for a, b in zip(written, back))
    prec = system.get_precision()
    check(len(back) == n_w and gap <= 0.5 / prec + 1e-6,
          f"XTC of the Protein ({n_w} frames, written with the TRR in {t_write:.2f} s) "
          f"reads back within half of 1/precision ({gap:.2e} <= {0.5 / prec:.1e})")
    back = [s.positions.copy() for s in prot.trr_iter(paths[1])]
    check(len(back) == n_w and all(np.array_equal(a, b) for a, b in zip(written, back)),
          "the TRR reads back bit for bit")
    for p in paths:
        os.unlink(p)

    # ---- map-reduce --------------------------------------------------------------
    w_t = torch.as_tensor(w, device=dev)
    pep = min(400, n_prot)

    def body(pos, boxes, mask):
        return {"com": C.center(pos[:, :n_prot], boxes[:, None, :], weights=w_t),
                "mindist": D.min_distance(pos[:, :pep], pos[:, n_prot:w0], boxes)}

    def fold(carry, out, mask):
        return {"sum": carry["sum"] + (out["com"] * mask[:, None]).sum(0),
                "min": torch.minimum(carry["min"],
                                     torch.where(mask, out["mindist"], torch.inf).min())}

    def init():
        return {"sum": torch.zeros(3, device=dev),
                "min": torch.full((), torch.inf, device=dev)}

    t0 = time.perf_counter()
    carry, out = system.traj_iter_map_reduce(xtc, body, init=init(), fold=fold,
                                             collect=True, batch_size=BATCH)
    t_mr = time.perf_counter() - t0
    for key in ("com", "mindist"):
        e = float(np.abs(out[key] - want[key]).max())
        check(out[key].shape[0] == N_FRAMES and e <= 1e-6,
              f"map-reduce per-frame {key} equals the runner's (max diff {e:.1e})")
    check(float(carry["min"]) == float(want["mindist"].min()),
          f"the folded minimum is the frames' ({float(carry['min']):.6f}; pass {t_mr:.2f} s)")
    ckpt = os.path.join(K.BUILD_DIR, "smoke_api_checkpoint.npz")
    if os.path.exists(ckpt):
        os.unlink(ckpt)
    calls = {"n": 0}

    def failing(pos, boxes, mask):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("stop after the second batch")
        return body(pos, boxes, mask)

    try:
        system.traj_iter_map_reduce(xtc, failing, init=init(), fold=fold,
                                    batch_size=BATCH, checkpoint=ckpt)
        stopped = False
    except ParallelError:
        stopped = True
    resumed = system.traj_iter_map_reduce(xtc, body, init=init(), fold=fold,
                                          batch_size=BATCH, checkpoint=ckpt)
    os.unlink(ckpt)
    same = all(torch.equal(resumed[k].cpu(), carry[k].cpu()) for k in carry)
    check(stopped and same, "a checkpointed pass stopped after its second batch resumes "
          "to the uninterrupted result, bit for bit")

    counts = dict(K.launch_counts)
    n_batches = -(-N_FRAMES // BATCH)
    # loop: com 1 + cog 1 + distance 2 per frame; fit: the reference's COM
    # and one per batch (48 frames, batch 64); frame 0: two estimates, make
    # group whole, atoms_center, the filtered COM; map-reduce: every batch,
    # the two before the stop and the rest after it
    predicted = {
        "bai_breen_estimate": 4 * N_FRAMES + 2 + 5 + 2 * n_batches,
        "bai_breen_refine": 4 * N_FRAMES + 2 + 1 + 2 * n_batches,
        "pair_reduce": 2 * n_batches}
    say(f"  launches {counts}, predicted {predicted}")
    if cuda:
        check(counts == predicted, "K1, K2 and K3 launched as the code predicts")
        ms = device_ms(lambda: system.group_get_com("Protein"), 10)
        say(f"  group_get_com('Protein'): {ms} device ms a call (profiler) against "
            f"{1e3 * np.median(lat):.3f} ms on the host clock")
        say(f"  max_memory_allocated over phase 12: "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    say(f"  phase 12 System-API seconds (after the runner's reference pass): "
        f"{time.perf_counter() - t_phase:.2f}")
    return counts


PCA_RESIDUES = 1000     # C-alpha atoms of the PCA, entropy and DCCM group
MDMAT_RESIDUES = 1000   # residues of mdmat (10 atoms each)
MDMAT_BAND = 250        # rows of the mdmat matrix the float64 oracle computes
DSSP8_FRAMES = 12       # frames of the 8-state DSSP run
DSSP_BAND = 2000        # residues whose energies the float64 oracle computes
# frames of the DSSP, Ramachandran, mdmat and clustsize float64 oracles
# (2 before phase 21 came: the whole smoke stays near 1000 s)
STRUCT_ORACLE_FRAMES = 1
CLUST_WATERS = 2000     # water molecules of clustsize
MODE_FRAMES = 30        # frames of morph and mode_traj
IDEAL_PIECES = 20       # helices of 50 residues and hairpins of 2 x 25


def _window(dt, a, b):
    """Frames [a, b) of a DeviceTrajectory as one (views, same layout)."""
    from groan_rs_tpu_torch.parallel import DeviceTrajectory

    w = DeviceTrajectory(dt.pos[a:b], dt.boxes[a:b], dt.inv_prec[a:b], dt.times[a:b],
                         dt.steps[a:b], dt.kind, dt.box_form)
    w.sel, w.sel_known = dt.sel, dt.sel_known
    return w


def _read_back(system, group, path, want, what):
    """The group's frames of an XTC written by the port, read back with the
    port's reader, within half of 1/precision of what was written, plus the
    float32 rounding of the scaled and of the decoded coordinate (an ulp
    each, of the largest coordinate)."""
    part = system.group_extract(group)
    back = [s.positions.copy() for s in part.xtc_iter(path)]
    gap = max(float(np.abs(b - a).max()) for a, b in zip(want, back))
    prec = system.get_precision()
    tol = 0.5 / prec + 2 * float(np.spacing(np.float32(max(np.abs(a).max() for a in want))))
    check(len(back) == len(want) and gap <= tol,
          f"{what}: {len(back)} frames of {back[0].shape[0]} atoms read back within half "
          f"of 1/precision and two ulps ({gap:.3e} <= {tol:.3e})")
    os.unlink(path)


def _fit_oracle_checks(ref0, coords, boxes, w, rmsf, rot, want_rmsd, mat):
    """rmsf, rotmat and rows 0 and F-1 of the RMSD matrix against the
    float64 `calc_rmsd_and_fit` (`testing.host_prepared` / `host_kabsch`).
    A frame whose shifted group puts an atom within 1e-5 nm of the wrap
    boundary may wrap that atom a box length away in float32: such atoms
    are excused from the RMSF, such frames from the RMSD (counted)."""
    from groan_rs_tpu_torch import testing

    f = coords.shape[0]
    pc, ref_com, _ = testing.host_prepared(ref0, boxes[0], w)
    qs, edges, r64, rot64, fitted = [], [], [], [], []
    for k in range(f):
        qc, _, edge = testing.host_prepared(coords[k], boxes[k], w)
        r, rr = testing.host_kabsch(pc, qc, w)
        qs.append(qc)
        edges.append(edge)
        r64.append(r)
        rot64.append(rr)
        fitted.append(qc @ rr + ref_com)
    edges = np.asarray(edges)
    fitted = np.asarray(fitted)
    rmsf64 = np.sqrt(((fitted - fitted.mean(0)) ** 2).sum(-1).mean(0))
    amb_atom = (edges < 1e-5).any(0)
    amb_frame = (edges < 1e-5).any(1)
    e = float(np.abs(rmsf - rmsf64)[~amb_atom].max())
    check(e <= 1e-4, f"rmsf vs float64 fit over {f} frames within 1e-4 nm (max err {e:.2e}; "
          f"{int(amb_atom.sum())} atoms within 1e-5 nm of the wrap boundary excused)")
    ok = ~amb_frame
    e = float(np.abs(rot["rmsd"][ok] - np.asarray(r64)[ok]).max())
    e_rot = float(np.abs(rot["matrices"][ok] - np.swapaxes(np.asarray(rot64), 1, 2)[ok]).max())
    check(e <= 1e-4 and e_rot <= 1e-4,
          f"rotmat vs float64 Kabsch within 1e-4: RMSD max err {e:.2e} nm, rotation max "
          f"err {e_rot:.2e} ({int(amb_frame.sum())} frames excused)")
    e = float(np.abs(rot["rmsd"] - want_rmsd).max())
    check(e <= 1e-5, f"rotmat's RMSD equals add_rmsd's within 1e-5 (max diff {e:.1e})")
    errs, skipped = [], 0
    for i in (0, f - 1):
        for j in range(f):
            if amb_frame[i] or amb_frame[j]:
                skipped += 1
                continue
            errs.append(abs(float(mat[i, j]) - testing.host_kabsch(qs[i], qs[j], w)[0]))
    check(max(errs) <= 1e-4, f"rmsd_matrix rows 0 and {f - 1} vs the float64 pair oracle "
          f"within 1e-4 nm (max err {max(errs):.2e}; {skipped} pairs excused)")
    asym = float(np.abs(mat - mat.T).max())
    diag = float(np.abs(np.diag(mat)).max())
    check(asym <= 1e-5 and diag <= 1e-5,
          f"rmsd_matrix symmetric ({asym:.1e}) with a zero diagonal ({diag:.1e}), within 1e-5")
    return amb_frame


def _dssp_oracle_checks(torch, coords, boxes, names, resnames, ss3, ss8, dev):
    """DSSP codes of the first `STRUCT_ORACLE_FRAMES` frames against
    float64 energies, on a band of
    `DSSP_BAND` residues: the float64 energies of the band's residues (8
    more on each side) as donors and as acceptors; the card's float32
    hydrogen bonds equal those there (away from 1e-4 kcal/mol of the
    cutoff, and from donors whose amide H float32 may place by another
    image: N-C or N-O of the previous residue within 1e-5 nm of half a
    box), and the band's 3- and 8-state codes equal
    `testing.host_dssp_codes` of the float64 bonds, except residues within
    6 of such a bond and, for the bends, residues whose CA(i-2)-CA(i) or
    CA(i)-CA(i+2) lies within 1e-5 nm of half a box (counted)."""
    from groan_rs_tpu_torch import testing
    from groan_rs_tpu_torch.ops import dssp as DS

    n_res = len(resnames)
    at = {nm: np.flatnonzero(names == nm) for nm in ("N", "CA", "C", "O")}
    check(all(len(v) == n_res for v in at.values()), "one N, CA, C and O per residue")
    donor_ok = np.asarray([rn != "PRO" for rn in resnames])
    donor_ok[0] = False
    consec = np.ones(n_res, bool)
    consec[-1] = False
    band = min(DSSP_BAND, n_res)
    lo = (n_res - band) // 2
    hi = lo + band
    wide = np.arange(max(0, lo - 8), min(n_res, hi + 8))

    def half_box(a, b, box):
        """Pairs whose float64 displacement lies within 1e-5 nm of half a box
        on an axis: float32 may take the other image (a bend, an amide H)."""
        d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
        return (np.abs(np.abs(d) - box / 2) < 1e-5).any(-1)

    t0 = time.perf_counter()
    for f in range(STRUCT_ORACLE_FRAMES):
        bb = {nm: coords[f][at[nm]] for nm in at}
        # donors whose amide H, and residues whose bend, float32 may place
        # by another image than float64
        tie_h = np.zeros(n_res, bool)
        tie_h[1:] = half_box(bb["N"][1:], bb["C"][:-1], boxes[f]) \
            | half_box(bb["N"][1:], bb["O"][:-1], boxes[f])
        tie_ca = half_box(bb["CA"][2:], bb["CA"][:-2], boxes[f])
        tie_s = np.zeros(n_res, bool)
        tie_s[2:n_res - 2] = tie_ca[:-2] | tie_ca[2:]
        e32 = DS.hbond_energy(*(torch.as_tensor(bb[nm][None], device=dev) for nm in at),
                              torch.as_tensor(boxes[f:f + 1], device=dev), donor_ok)[0]
        w_t = torch.as_tensor(wide, device=dev)
        hb_rows = (e32.index_select(0, w_t) < DS.KS_CUTOFF).cpu().numpy()
        hb_cols = (e32.index_select(1, w_t) < DS.KS_CUTOFF).cpu().numpy()
        del e32
        e_rows = testing.host_dssp_energy(*(bb[nm] for nm in at), boxes[f], donor_ok, rows=wide)
        e_cols = testing.host_dssp_energy(*(bb[nm] for nm in at), boxes[f], donor_ok, cols=wide)
        amb_r = (np.abs(e_rows - DS.KS_CUTOFF) < 1e-4) | tie_h[wide][:, None]
        amb_c = (np.abs(e_cols - DS.KS_CUTOFF) < 1e-4) | tie_h[:, None]
        same = ((hb_rows == (e_rows < DS.KS_CUTOFF)) | amb_r).all() and \
            ((hb_cols == (e_cols < DS.KS_CUTOFF)) | amb_c).all()
        n_hb = int((e_rows < DS.KS_CUTOFF).sum() + (e_cols < DS.KS_CUTOFF).sum())
        check(same, f"frame {f}: the card's hydrogen bonds of residues {wide[0]}..{wide[-1]} "
              f"(donors and acceptors) equal float64's ({n_hb} bonds; "
              f"{int(amb_r.sum() + amb_c.sum())} energies within 1e-4 of the cutoff or of a donor "
              "at a half-box tie excused)")
        hb = np.zeros((n_res, n_res), bool)
        hb[wide] = e_rows < DS.KS_CUTOFF
        hb[:, wide] = e_cols < DS.KS_CUTOFF
        excused = np.zeros(n_res, bool)
        for j, i in list(zip(wide[np.nonzero(amb_r)[0]], np.nonzero(amb_r)[1])) + \
                list(zip(np.nonzero(amb_c)[0], wide[np.nonzero(amb_c)[1]])):
            for k in (i, j):
                excused[max(0, k - 6):k + 7] = True
        for states, got in ((3, ss3[f]), (8, ss8[f])):
            want = testing.host_dssp_codes(hb, consec, states, coords[f][at["CA"]], boxes[f],
                                           residues=(lo, hi))
            got = got[lo:hi]
            skip = (excused | (tie_s if states == 8 else False))[lo:hi]
            bad = (want != got) & ~skip
            check(not bad.any(), f"frame {f}: {states}-state codes of residues {lo}..{hi - 1} "
                  f"equal the host oracle's ({int(skip.sum())} excused, {int((want != got).sum())} "
                  f"differ; " + ", ".join(f"{c} {int((got == c).sum())}" for c in np.unique(got))
                  + f"{'' if not bad.any() else '; first ' + str(lo + np.flatnonzero(bad)[:10])})")
    say(f"  DSSP oracle (host float64, {STRUCT_ORACLE_FRAMES} frames): "
        f"{time.perf_counter() - t0:.1f} s")


def structure_phase(torch, xtc, offs, nat, box, system, dev):
    """Phase 13: the conformational analyses of `models/structure.py` and
    the frame converters on phase 10's System -> the K1/K2/K3 launches of
    its main path."""
    from groan_rs_tpu_torch import convert, testing
    from groan_rs_tpu_torch import models as M
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.ops import center as C
    from groan_rs_tpu_torch.ops import kernels as K

    say(f"phase 13: conformational analyses, {nat} atoms x {N_FRAMES} frames")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    lay = testing.synthetic_layout(nat)
    n_prot, w0 = lay["n_prot"], lay["w0"]
    n_res = n_prot // testing.RESIDUE_SIZE
    n_pca, n_md = min(PCA_RESIDUES, n_res), min(MDMAT_RESIDUES, n_res)
    n_wat = min(CLUST_WATERS, (nat - w0) // 3)
    _, _, times, _ = native.xtc_scan(xtc)
    next(iter(system.xtc_iter(xtc, end_time=float(times[0]))))   # frame 0: the reference
    queries = {"CApca": f"Protein and name CA and resid 1 to {n_pca}",
               "CAall": "Protein and name CA",
               "Resmd": f"Protein and resid 1 to {n_md}",
               "Waters": f"Water and serial {w0 + 1} to {w0 + 3 * n_wat}"}
    for g, q in queries.items():
        system.group_create(g, q)
    sizes = {g: system.group_get_n_atoms(g) for g in queries}
    check(sizes == {"CApca": n_pca, "CAall": n_res, "Resmd": 10 * n_md, "Waters": 3 * n_wat},
          f"GSL groups {sizes}")
    ref = system.copy()                  # frame 0, before the converters move it
    # phase 11's guessed bonds join the synthetic waters (random O-H-H
    # triplets at ~22 a nm^3) into molecules of thousands of atoms, whose
    # padded [R, P, P, 3] tiles would not fit the card: clustsize takes the
    # layout's own bonds, one molecule per water
    layout_bonds = system.copy()
    layout_bonds.topology.set_bonds_from_pairs(
        np.concatenate([lay["lipid_bonds"], lay["water_bonds"]]))
    w = system.topology.mass[:n_prot]
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    paths = {k: os.path.join(K.BUILD_DIR, f"smoke_{k}.xtc") for k in ("morph", "modes", "fit")}
    half = N_FRAMES // 2
    n_conv = min(BATCH, N_FRAMES)
    last = native.xtc_read_frames(xtc, offs[N_FRAMES - 1:N_FRAMES], nat)[0][0]

    # ---- the phase's main path: what a user calls --------------------------
    K.reset_launch_counts()
    t_main = time.perf_counter()
    dt_prot = timed("load Protein", lambda: M.TrajectoryAnalysis(system, device=dev).runner(
        group="Protein").load_device(xtc, batch_size=BATCH))
    dt_ca = timed("load CApca", lambda: M.TrajectoryAnalysis(system, device=dev).runner(
        group="CApca").load_device(xtc, batch_size=BATCH))
    _, rmsf = timed("rmsf (from the file)", lambda: M.rmsf(system, xtc, "Protein",
                                                          batch_size=BATCH))
    _, rmsf_nofit = timed("rmsf fit=False", lambda: M.rmsf(system, dt_prot, "Protein", fit=False))
    rot = timed("rotmat", lambda: M.rotmat(system, dt_prot, "Protein"))
    _, mat = timed("rmsd_matrix", lambda: M.rmsd_matrix(system, dt_prot, "Protein"))
    off = mat[np.triu_indices(N_FRAMES, 1)]
    cuts = {"gromos": float(np.median(off)), "linkage": float(np.quantile(off, 0.1)),
            "jarvis-patrick": 0.0}
    clusters = timed("cluster x3", lambda: {m: M.cluster(system, matrix=mat, cutoff=c, method=m,
                                                         jp_m=3, jp_p=1)
                                            for m, c in cuts.items()})
    end_b = system.copy()
    end_b.positions[:] = last
    mo = timed("morph", lambda: M.morph(system, end_b, n=MODE_FRAMES, group="Protein",
                                        output=paths["morph"]))
    d3 = timed("dssp 3-state", lambda: M.dssp(system, dt_prot, "Protein", states=3))
    d8 = timed("dssp 8-state", lambda: M.dssp(system, _window(dt_prot, 0, DSSP8_FRAMES),
                                              "Protein", states=8))
    rama = timed("ramachandran", lambda: M.ramachandran(system, xtc, "Protein",
                                                        batch_size=BATCH))
    pc = timed("pca", lambda: M.pca(system, dt_ca, "CApca"))
    ent = timed("entropy", lambda: M.entropy(system, dt_ca, "CApca"))
    dc = timed("dccm", lambda: M.dccm(system, dt_ca, "CApca"))
    halves = timed("pca of the halves", lambda: [
        M.pca(system, _window(dt_ca, a, b), "CApca", n_components=10)
        for a, b in ((0, half), (half, N_FRAMES))])
    ov = M.subspace_overlap(*halves, n=10)
    cc = M.cosine_content(pc["projections"], n_modes=5)
    mt = timed("mode_traj", lambda: M.mode_traj(system, pc, "CApca", n=MODE_FRAMES,
                                                output=paths["modes"]))
    rd = timed("rmsdist", lambda: M.rmsdist(system, xtc, "CAall", batch_size=BATCH))
    md = timed("mdmat", lambda: M.mdmat(system, xtc, "Resmd", per_frame=True, batch_size=BATCH))
    cs = timed("clustsize", lambda: M.clustsize(layout_bonds, xtc, "Waters", cutoff=0.35,
                                                batch_size=BATCH))
    converted = []

    def conversion():
        system.group_traj_writer_init("Protein", paths["fit"])
        for s in M.convert_iter(system.xtc_iter(xtc, end_time=float(times[n_conv - 1])),
                                [M.FitConverter(ref, "Protein"), M.WrapConverter()]):
            s.traj_write_frame()
            converted.append(s.positions[:n_prot].copy())
        system.traj_close()

    timed("convert_iter (fit + wrap, written)", conversion)
    t_main = time.perf_counter() - t_main
    counts = dict(K.launch_counts)
    say("  seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    say(f"  the phase's main path: {t_main:.2f} s")
    if cuda:
        say(f"  max_memory_allocated over the main path: "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    # centres: rmsf x2, rotmat, pca, entropy, dccm, the two halves: 2 each
    # (the reference's COM and the window's); rmsd_matrix 1 (the window's);
    # morph 7 (calc_rmsd_and_fit 3, two endpoint series of 2); every
    # converted frame 3 (calc_rmsd_and_fit)
    k12 = 2 * 8 + 1 + 7 + 3 * n_conv
    predicted = {"bai_breen_estimate": k12, "bai_breen_refine": k12, "pair_reduce": 0}
    say(f"  launches {counts}, predicted {predicted}")
    if cuda:
        check(counts == predicted, "K1, K2 and K3 launched as the code predicts")

    # ---- the results against float64 oracles -------------------------------
    t0 = time.perf_counter()
    coords, b9s, *_ = native.xtc_read_frames(xtc, offs[:N_FRAMES], nat, stop_after=w0)
    boxes = b9s[:, [0, 4, 8]].astype(np.float64)
    for key, v in (("rmsf", rmsf), ("rmsf fit=False", rmsf_nofit)):
        check(v.shape == (n_prot,) and np.isfinite(v).all(), f"{key}: {v.shape} finite")
    want = (M.TrajectoryAnalysis(ref, device=dev).add_rmsd("Protein", reference=ref, name="rmsd")
            .runner().run(xtc, batch_size=BATCH))
    _fit_oracle_checks(ref.positions[:n_prot], coords[:, :n_prot], boxes, w, rmsf, rot,
                       want["rmsd"], mat)
    for m, res in clusters.items():
        host = testing.host_clusters(mat, m, cuts[m], jp_m=3, jp_p=1)
        check(np.array_equal(res["labels"], host),
              f"cluster {m}: labels equal the host re-run ({len(res['sizes'])} clusters, "
              f"sizes {res['sizes'][:5].tolist()})")
    ca_idx = ref.group_indices("CApca")
    w_ca = ref.topology.mass[ca_idx]
    pc_ref, com_ca, _ = testing.host_prepared(ref.positions[ca_idx], boxes[0], w_ca)
    fit_ca, edge_ca = [], []
    for k in range(N_FRAMES):
        qc, _, edge = testing.host_prepared(coords[k][ca_idx], boxes[k], w_ca)
        fit_ca.append(qc @ testing.host_kabsch(pc_ref, qc, w_ca)[1] + com_ca)
        edge_ca.append(edge.min())
    fit_ca = np.asarray(fit_ca)
    lam64 = testing.host_covariance_eigh(fit_ca, np.sqrt(w_ca.astype(np.float64)))
    e = float(np.abs(pc["eigenvalues"] - lam64).max() / lam64[0])
    check(e <= 1e-3, f"PCA: {len(lam64)} eigenvalues vs float64 covariance eigh within 1e-3 of "
          f"the largest ({e:.1e}; leading {pc['eigenvalues'][:3].tolist()} amu nm^2; closest "
          f"C-alpha to a wrap boundary {min(edge_ca):.1e} nm)")
    # the entropies: the card's sums over its own eigenvalues, and the modes
    # the 48 frames determine (rank F - 1) against float64; the other modes
    # are null, and their float32 noise adds to both sums (as in the JAX
    # package): printed, not held to float64
    keys = ("schlitter", "quasiharmonic")
    own = testing.host_entropy(ent["eigenvalues"], 300.0)
    e_own = max(abs(ent[k] - v) / v for k, v in zip(keys, own))
    rank = N_FRAMES - 1
    top, top64 = (testing.host_entropy(x[:rank], 300.0) for x in (ent["eigenvalues"], lam64))
    e_top = max(abs(a - b) / b for a, b in zip(top, top64))
    full64 = testing.host_entropy(lam64, 300.0)
    check(e_own <= 1e-12 and e_top <= 1e-3,
          f"entropy: Schlitter {ent['schlitter']:.6f}, quasi-harmonic "
          f"{ent['quasiharmonic']:.6f} kJ/(mol K), the formulas of its eigenvalues "
          f"({e_own:.1e}); over the {rank} modes of rank within rel 1e-3 of float64 "
          f"({e_top:.1e}); the null modes' float32 noise adds "
          f"{ent['schlitter'] - top[0]:.6f} and {ent['quasiharmonic'] - top[1]:.6f} "
          f"(float64: {full64[0] - top64[0]:.2e}, {full64[1] - top64[1]:.2e})")
    d = fit_ca - fit_ca.mean(0)
    c64 = np.einsum("fid,fjd->ij", d, d) / N_FRAMES
    e = float(np.abs(dc["covariance"] - c64).max() / np.abs(c64).max())
    check(e <= 1e-3 and np.array_equal(np.diag(dc["dccm"]), np.ones(n_pca, np.float32)),
          f"dccm: covariance within 1e-3 of its largest float64 entry ({e:.1e}), unit diagonal")
    check(0.0 <= ov["rmsip"] <= 1.0 + 1e-9 and np.isfinite(cc).all()
          and mt["frames"].shape == (MODE_FRAMES, n_pca, 3),
          f"subspace overlap of the halves: RMSIP {ov['rmsip']:.4f}, covariance overlap "
          f"{ov['covariance_overlap']:.4f}; cosine content {np.round(cc, 4).tolist()}")
    _dssp_oracle_checks(torch, coords[:, :n_prot], boxes,
                        np.asarray(ref.topology.atomname.values()[:n_prot], str),
                        d3["resnames"], d3["ss"], d8["ss"], dev)
    check(d3["ss"].shape == (N_FRAMES, n_res) and d8["ss"].shape == (DSSP8_FRAMES, n_res),
          f"dssp: [{N_FRAMES}, {n_res}] 3-state codes {d3['frac']}, [{DSSP8_FRAMES}, {n_res}] "
          "8-state")
    k = np.arange(1, n_res - 1) * testing.RESIDUE_SIZE
    sites = {"phi": (k - 3, k, k + 2, k + 7), "psi": (k, k + 2, k + 7, k + 10)}
    nf = STRUCT_ORACLE_FRAMES
    x = coords[:nf].astype(np.float64)
    half = boxes[:nf, None, :] / 2
    for key, (a, b, c, dd) in sites.items():
        want_deg = testing.dihedrals_host_f64(x[:, a], x[:, b], x[:, c], x[:, dd], boxes[:nf])
        got = rama[key][:nf]
        # the named layout's backbone atoms are random points: a bond vector
        # within 1e-5 nm of half a box on an axis may take the other image in
        # float32 (as in the JAX package), which moves the dihedral
        tie = np.zeros(got.shape, bool)
        for p, q in ((a, b), (b, c), (c, dd)):
            tie |= (np.abs(np.abs(x[:, q] - x[:, p]) - half) < 1e-5).any(-1)
        e = float(np.abs((got - want_deg + 180) % 360 - 180)[~tie].max())
        check(got.shape[1] == n_res - 2 and e <= 2e-2,
              f"ramachandran {key}: {got.shape[1]} residues, within 2e-2 degrees of float64 on "
              f"{nf} frames ({e:.1e}; {int(tie.sum())} sites with a bond at a half-box tie excused)")
    blocks = np.arange(10 * n_md).reshape(n_md, 10)
    band = slice(0, min(MDMAT_BAND, n_md))
    for f in range(nf):
        want_md = testing.host_residue_min(coords[f], boxes[f], blocks, rows=blocks[band])
        e = float(np.abs(md["frames"][f][band] - want_md).max())
        check(md["frames"].shape == (N_FRAMES, n_md, n_md) and e <= 1e-5,
              f"mdmat frame {f}: rows 0..{want_md.shape[0] - 1} of the {n_md} x {n_md} residue "
              f"matrix within 1e-5 nm of float64 ({e:.1e})")
    # the waters' molecules by the guessed bonds (some waters overlap and bond)
    wat = w0 + np.arange(3 * n_wat)
    guessed = np.bincount(np.unique(ref.topology.molecule_ids()[wat], return_inverse=True)[1])
    say(f"  phase 11's guessed bonds put the {3 * n_wat} atoms of the {n_wat} waters into "
        f"{len(guessed)} molecules, the largest of {guessed.max()} of them")
    mol = layout_bonds.topology.molecule_ids()[wat]
    _, first = np.unique(mol, return_index=True)
    wblocks = [wat[mol == mol[i]] for i in np.sort(first)]
    ww = native.xtc_read_frames(xtc, offs[:nf], nat, stop_after=w0 + 3 * n_wat)[0]
    from groan_rs_tpu_torch.models.structure import _connected_components

    def function_of(a, b):                 # every class of a lies in one class of b
        return len(np.unique(np.stack([a, b], 1), axis=0)) == len(np.unique(a))

    for f in range(nf):
        # grid coordinates meet the cutoff exactly (0.35^2 nm^2 is a sum of
        # squared grid steps), where float32 may decide either way: the
        # clusters must lie between those of d < 0.35 - 1e-5 and d < 0.35 + 1e-5
        dmin = testing.host_residue_min(ww[f], boxes[f], wblocks)
        strict = _connected_components(dmin < 0.35 - 1e-5)
        loose = _connected_components(dmin < 0.35 + 1e-5)
        got = cs["labels"][f]
        exact = np.array_equal(strict, loose)
        check(function_of(strict, got) and function_of(got, loose)
              and (not exact or np.array_equal(got, strict)),
              f"clustsize frame {f}: {cs['n_clusters'][f]} clusters of the {len(wblocks)} "
              f"molecules of {n_wat} waters (largest {cs['max_size'][f]}) equal the float64 "
              f"contact graph's{'' if exact else ' up to the ties'} "
              f"({int((np.abs(dmin - 0.35) < 1e-5).sum()) // 2} molecule pairs within 1e-5 nm "
              "of the cutoff)")
    check(float(rd["rmsdist"][0]) <= 1e-5 and np.isfinite(rd["rmsdist"]).all(),
          f"rmsdist of the {n_res} C-alphas: frame 0 (the reference) {rd['rmsdist'][0]:.1e}, "
          f"frame {N_FRAMES - 1} {rd['rmsdist'][-1]:.4f} nm")
    check(np.abs(mo["rmsd_a"][0]) <= 1e-5 and np.abs(mo["rmsd_b"][-1]) <= 1e-4,
          f"morph: RMSD to A at lambda 0 {mo['rmsd_a'][0]:.1e}, to B at lambda 1 "
          f"{mo['rmsd_b'][-1]:.1e}")
    _read_back(system, "Protein", paths["morph"], mo["frames"], "morph XTC")
    _read_back(system, "CApca", paths["modes"], mt["frames"], "mode_traj XTC")
    _read_back(system, "Protein", paths["fit"], converted, "convert_iter (fit + wrap) XTC")
    say(f"  oracles {time.perf_counter() - t0:.1f} s")

    # ---- the known answer: ideal helices and hairpins ----------------------
    helix, hairpin = testing.ideal_backbone(50, *testing.HELIX_PHI_PSI), testing.ideal_hairpin(25)
    pieces = ([(helix, f"H{i}", 0) for i in range(IDEAL_PIECES)]
              + [(hairpin, f"E{i}", 25) for i in range(IDEAL_PIECES)])
    state = testing.backbone_state(pieces)
    ideal = convert.system_from_state(state, device=dev)
    ipath = os.path.join(K.BUILD_DIR, "smoke_ideal.xtc")
    if os.path.exists(ipath):
        os.unlink(ipath)
    native.xtc_write_frame(ipath, len(state["positions"]), 0, 0.0,
                           np.diag(state["box"]).reshape(9), state["positions"], 10000.0)
    for states in (3, 8):
        ss = M.dssp(ideal, ipath, "Backbone", states=states)["ss"][0].reshape(-1, 50)
        hel, hp = ss[:IDEAL_PIECES], ss[IDEAL_PIECES:]
        ok = (hel[:, 3:49] == "H").all() and (hp[:, 1:23] == "E").all() \
            and (hp[:, 27:49] == "E").all()
        check(ok, f"dssp ({states}-state) of {IDEAL_PIECES} ideal helices and {IDEAL_PIECES} "
              f"hairpins ({ss.size} residues): helix interiors H, strands E "
              f"(e.g. {''.join(hel[0])} / {''.join(hp[0])})")
    os.unlink(ipath)

    # ---- the kernel path against the twin path --------------------------------
    dt4 = _window(dt_prot, 0, 4)
    cpu = ref.copy()
    cpu.set_device("cpu")
    pos4 = (dt4.pos.float() * dt4.inv_prec[:, None, None]).contiguous()
    bx4 = dt4.boxes
    wt = torch.as_tensor(w, device=pos4.device)
    com_k = C.center(pos4, bx4[:, None, :], weights=wt).cpu()
    com_p = C.center(pos4.cpu(), bx4.cpu()[:, None, :], weights=wt.cpu())
    est_k = K.bai_breen_estimate(pos4, None, bx4).cpu().numpy()
    est_p = K.bai_breen_estimate(pos4.cpu(), None, bx4.cpu()).numpy()
    flips, jump = testing.center_jump_bound(pos4.cpu().numpy(), est_k, est_p, bx4.cpu().numpy())
    gap = float((com_k - com_p).abs().max())
    check(gap <= 1e-4 + float(jump.max()),
          f"fit COM, kernel path vs twin path on 4 frames: {gap:.2e} (1e-4 plus the image "
          f"changes, {int(flips.sum())} atoms)")
    bc = bx4.cpu().numpy()[:, None, :] / 2
    p4 = pos4.cpu().numpy()

    def image(com):
        return np.floor((p4 + bc - com.numpy()[:, None, :]) / (2 * bc))

    moved = (image(com_k) != image(com_p)).any(-1)        # [4, K]: wrapped otherwise
    r_k, r_p = M.rmsf(ref, dt4, "Protein")[1], M.rmsf(cpu, dt4, "Protein")[1]
    m_k, m_p = M.rmsd_matrix(ref, dt4, "Protein")[1], M.rmsd_matrix(cpu, dt4, "Protein")[1]
    e_r = float(np.abs(r_k - r_p)[~moved.any(0)].max())
    fr = ~moved.any(1)
    e_m = float(np.abs(m_k - m_p)[np.ix_(fr, fr)].max()) if fr.any() else 0.0
    check(e_r <= 1e-4 and e_m <= 1e-4,
          f"kernel path vs twin path (K1 + K2 on the card against their plain twins on the "
          f"CPU): rmsf {e_r:.1e}, rmsd_matrix rows 0-3 {e_m:.1e}, within 1e-4 "
          f"({int(moved.any(0).sum())} atoms wrapped into another image excused)")
    say(f"  phase 13 seconds after the main path: {time.perf_counter() - t0:.1f}")
    return counts


DYN_TRR_FRAMES = 24       # frames of the velocity TRR (phase 4's first 24 positions)
VANHOVE_ORACLE_LAGS = (1, 2, 23, 47)   # lags whose counts the float64 oracle recounts


def _dyn_close(got, want, what, rel=1e-4):
    """A curve within `rel` of its largest float64 value."""
    e = _rel(got, want)
    check(np.shape(got) == np.shape(want) and np.isfinite(got).all() and e <= rel,
          f"{what} within {rel:g} of the float64 oracle's largest value ({e:.2e})")


def _dyn_value(got, want, what, rel=1e-4):
    e = float(np.max(np.abs(np.asarray(got, np.float64) - want) / np.abs(want)))
    check(e <= rel, f"{what} within relative {rel:g} of float64 ({e:.2e}; "
          f"{np.ravel(got)[:4].tolist()})")


def dynamics_phase(torch, xtc, offs, nat, frame0, box, dev):
    """Phase 14: the time-correlation and transport analyses of
    `models/dynamics.py` over phase 4's XTC and a 24-frame TRR -> the
    K1/K2/K3 launches of its main path (predicted 0)."""
    from groan_rs_tpu_torch import convert, testing
    from groan_rs_tpu_torch import models as M
    from groan_rs_tpu_torch.core.simbox import SimBox
    from groan_rs_tpu_torch.errors import ParallelError
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.models import dynamics as D
    from groan_rs_tpu_torch.ops import kernels as K
    from groan_rs_tpu_torch.system.hbonds import HBondAnalysis, HBondChain

    say(f"phase 14: time-correlation and transport analyses, {nat} atoms x {N_FRAMES} frames")
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    lay = testing.synthetic_layout(nat)
    w0 = lay["w0"]
    state = testing.synthetic_state(frame0.copy(), box, topology="full")
    system = convert.system_from_state(state, device=dev)
    system.group_create("OW", "name OW")
    oxy = lay["water_oxygens"]
    pairs = np.stack([oxy + 1, oxy], 1)[oxy + 1 < nat]          # OW -> HW1
    n_dense = min(DENSE_WATERS, len(oxy) - 1)
    span = f"serial {w0 + 1} to {w0 + 3 * n_dense}"
    chain = [HBondChain(f"name OW and {span}", f"name OW and {span}",
                        f"name HW1 HW2 and {span}")]

    # ---- the TRR: phase 4's first positions, AR(1) velocities -------------
    t0 = time.perf_counter()
    n_trr = min(DYN_TRR_FRAMES, N_FRAMES)
    coords, b9s, steps, times = native.xtc_read_frames(xtc, offs[:N_FRAMES], nat)[:4]
    boxes = b9s[:, [0, 4, 8]].astype(np.float64)
    vel = testing.ar1_velocities(n_trr, nat, seed=29)
    trr = os.path.join(K.BUILD_DIR, f"smoke_dyn_{nat}_{n_trr}.trr")
    testing.write_trr(trr, coords[:n_trr], b9s[:n_trr], times[:n_trr], steps[:n_trr], vel)
    say(f"  TRR of {n_trr} frames (AR(1) velocities, phi 0.9, 0.3 nm/ps) written in "
        f"{time.perf_counter() - t0:.1f} s ({os.path.getsize(trr) / 1e6:.0f} MB)")
    paths = {w: os.path.join(K.BUILD_DIR, f"smoke_filter_{w}.xtc") for w in ("plain", "wrap")}
    for path in paths.values():
        if os.path.exists(path):
            os.unlink(path)

    secs = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        return out

    # ---- the phase's main path: what a user calls, from the file names -----
    K.reset_launch_counts()
    t_main = time.perf_counter()
    lt, msd_xyz = timed("msd OW xyz", lambda: M.msd(system, xtc, "OW", batch_size=BATCH))
    dif = {d: timed(f"diffusion OW {d}", lambda d=d: M.diffusion(
        system, xtc, "OW", dims=d, batch_size=BATCH)) for d in ("xyz", "xy")}
    mol = timed("msd_mol Membrane xy", lambda: M.msd_mol(system, xtc, "Membrane", dims="xy",
                                                        batch_size=BATCH))
    vh = timed("vanhove Water", lambda: M.vanhove(system, xtc, "Water", lags=range(1, N_FRAMES),
                                                  r_max=2.0, bins=100, batch_size=BATCH))
    rot = {o: timed(f"rotacf P{o}", lambda o=o: M.rotacf(system, xtc, pairs, order=o,
                                                        batch_size=BATCH)[1]) for o in (1, 2)}
    cur = timed("current all", lambda: M.current(system, xtc, "all", temperature=300.0,
                                                 fit_range=(0.1, 0.5), batch_size=BATCH))
    vac = {m: timed(f"vacf Water mass_weighted={m}", lambda m=m: M.vacf(
        system, trr, "Water", mass_weighted=m, batch_size=BATCH)[1]) for m in (False, True)}
    ds = timed("dos Water", lambda: M.dos(system, trr, "Water", batch_size=BATCH))
    tc = timed("tcaf Water", lambda: M.tcaf(system, trr, "Water", n_k=4, batch_size=BATCH))
    dip = {m: timed(f"dipole_corr {m}", lambda m=m: M.dipole_corr(
        system, xtc, "Water", mode=m, batch_size=BATCH)) for m in ("total", "mol")}
    hb_acf = timed("hbond_acf", lambda: M.hbond_acf(system, xtc, chain, [(0, 0)],
                                                    batch_size=BATCH)[1])
    hb_life = timed("hbond_lifetime", lambda: M.hbond_lifetime(system, xtc, chain, [(0, 0)],
                                                               batch_size=BATCH))
    for w, path in paths.items():
        n_w = timed(f"filter_traj Protein ({w})", lambda w=w, path=path: M.filter_traj(
            system, xtc, path, window=5, group="Protein", wrap=w == "wrap",
            batch_size=BATCH))
        check(n_w == N_FRAMES, f"filter_traj ({w}) wrote {n_w} frames")
    t_main = time.perf_counter() - t_main
    counts = dict(K.launch_counts)
    say("  seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    say(f"  the phase's main path: {t_main:.2f} s")
    if cuda:
        say(f"  max_memory_allocated over the main path: "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    # no function of the family computes a centre or a pair reduction
    predicted = {"bai_breen_estimate": 0, "bai_breen_refine": 0, "pair_reduce": 0}
    say(f"  launches {counts}, predicted {predicted}")
    check(counts == predicted, "K1, K2 and K3 launched as the code predicts")

    # ---- against float64 oracles --------------------------------------------
    # the oracles are independent numpy work that releases the GIL in its
    # large array operations: four threads compute them while the checks
    # below read them in order (and the hydrogen-bond pass uses the card)
    t_or = time.perf_counter()
    lags = np.arange(N_FRAMES)
    ow, mem, wat, p = (system.group_indices(g) for g in ("OW", "Membrane", "Water", "Protein"))
    k_w = len(wat)
    olags = [x for x in VANHOVE_ORACLE_LAGS if x < N_FRAMES]
    q = system.topology.charge.astype(np.float64)
    m_w = system.topology.mass[wat].astype(np.float64)
    t_trr = times[:n_trr] - times[0]
    oracle_secs = {}

    def current_oracle():
        u_all = testing.host_unwrap(coords, boxes)
        return testing.host_dipole_paths(u_all, q), float(np.abs(u_all).max())

    def dipole_oracle():
        tot, mu = testing.host_molecular_dipoles(
            coords[:, wat], boxes, system.topology.molecule_ids()[wat],
            system.topology.mass[wat], system.topology.charge[wat])
        return testing.host_lag_corr(tot[:, None, :], lags), testing.host_lag_corr(mu, lags), \
            mu.shape[1]

    jobs = {
        "msd, diffusion": lambda: testing.host_msd_axes(
            testing.host_unwrap(coords[:, ow], boxes), lags),
        "msd_mol": lambda: testing.host_msd(testing.host_com_paths(
            testing.host_unwrap(coords[:, mem], boxes), system.topology.molecule_ids()[mem],
            system.topology.mass[mem]), lags, (0, 1), per_entity=True),
        "vanhove": lambda: testing.host_vanhove(
            testing.host_unwrap(coords[:, wat], boxes), olags, 2.0, 100),
        "rotacf": lambda: testing.host_lag_corrs(testing.host_unit_vectors(
            coords[:, pairs[:, 0]], coords[:, pairs[:, 1]], boxes), lags,
            [(None, 1), (None, 2)]),
        "current": current_oracle,
        "vacf, dos": lambda: testing.host_lag_corrs(vel[:, wat], np.arange(n_trr),
                                                    [(None, 1), (m_w, 1)]),
        "tcaf": lambda: testing.host_tcaf(coords[:n_trr, wat], vel[:, wat], m_w, boxes[0], 4,
                                          0.3, float(t_trr[1])),
        "dipole_corr": dipole_oracle,
        "filter_traj": lambda: testing.host_filtered(
            testing.host_unwrap(coords[:, p], boxes), 5),
    }

    def timed_job(name, fn):
        t = time.perf_counter()
        out = fn()
        oracle_secs[name] = time.perf_counter() - t
        return out

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=ORACLE_THREADS) as pool:
        fut = {k: pool.submit(timed_job, k, fn) for k, fn in jobs.items()}

        per_axis = fut["msd, diffusion"].result()
        check(np.array_equal(lt, times - times[0]), "msd lag times are the frames' times")
        _dyn_close(msd_xyz, per_axis.sum(1), f"msd of the {len(ow)} water oxygens (48 lags)")
        for d, axes in (("xyz", (0, 1, 2)), ("xy", (0, 1))):
            curve = per_axis[:, axes].sum(1)
            _dyn_close(dif[d]["msd"], curve, f"diffusion {d}: the MSD")
            slope = testing.host_fit(lt, curve, 0.1, 0.9)[0]
            _dyn_value(dif[d]["D"], slope / (2 * len(axes)) * 1e-2,
                       f"diffusion {d}: D (cm^2/s)")

        want = fut["msd_mol"].result()
        check(mol["n_molecules"] == -(-len(mem) // testing.LIPID_SIZE),
              f"msd_mol: {mol['n_molecules']} lipids")
        _dyn_close(mol["msd"], want, "msd_mol: the lipids' lateral COM curves")
        d64 = testing.host_fit(lt, want, 0.1, 0.9)[0] / 4 * 1e-2
        e = float(np.abs(mol["D"] - d64).max() / np.abs(d64).max())
        check(e <= 1e-4, f"msd_mol: the {len(d64)} lateral D within 1e-4 of the largest "
              f"float64 D ({e:.2e}; mean {mol['D_mean']:.4e} cm^2/s)")

        total = vh["counts"].sum(1) + np.rint(vh["overflow"] * (N_FRAMES - vh["lags"]) * k_w)
        check(vh["counts"].dtype == np.int64
              and np.array_equal(total, (N_FRAMES - vh["lags"]) * k_w),
              f"vanhove: the int64 counts of every lag sum to (F - lag) x {k_w} exactly")
        big = int(vh["counts"].max())
        say(f"  vanhove: the fullest shell holds {big} displacements "
            f"({'above' if big > 2 ** 24 else 'below'} 2^24 = {2 ** 24}), at lag "
            f"{int(vh['lags'][np.argmax(vh['counts'].max(1))])}")
        host, edge = fut["vanhove"].result()
        rows = np.searchsorted(vh["lags"], olags)
        got = np.concatenate([vh["counts"][rows], np.rint(
            vh["overflow"][rows] * (N_FRAMES - np.asarray(olags)) * k_w)[:, None]], 1)
        moved = np.abs(got - host).sum(1) // 2
        check((moved <= edge).all(),
              f"vanhove lags {olags}: counts equal float64's but for {moved.tolist()} "
              f"displacements, of {edge.tolist()} within 1e-6 nm of a shell edge")

        for o, want in zip((1, 2), fut["rotacf"].result()):
            _dyn_close(rot[o], want, f"rotacf P{o} of the {len(pairs)} OW -> HW1 vectors")

        mj, u_max = fut["current"].result()
        want = np.array([((mj[lag:] - mj[:N_FRAMES - lag]) ** 2).sum(1).mean() for lag in lags])
        bound = testing.current_bound(q, u_max, want)
        err = np.abs(cur["mj2"] - want)
        check((err[1:] <= bound[1:]).all(),
              f"current: mj2 within testing.current_bound at every lag >= 1 (largest error "
              f"{(err[1:] / want[1:]).max():.2e} relative, the bound's "
              f"{(bound[1:] / want[1:]).min():.2e}-{(bound[1:] / want[1:]).max():.2e}; u_max "
              f"{u_max:.2f} nm)")
        slope, _, mask = testing.host_fit(lt, want, 0.1, 0.5, positive=True)
        pinv = np.linalg.pinv(np.stack([lt[mask], np.ones(int(mask.sum()))], 1))
        slope_bound = float(np.abs(pinv[0]) @ bound[mask])
        e = abs(cur["slope"] - slope) / abs(slope)
        check(e <= slope_bound / abs(slope),
              f"current: conductivity {cur['conductivity']:.6e} S/m within the bound's "
              f"relative {slope_bound / abs(slope):.2e} of float64 ({e:.2e}; net charge "
              f"{cur['net_charge']:.2e} e)")
        say(f"  current: mj2 error / bound, largest {(err[1:] / bound[1:]).max():.3f}")

        c_u, c_m = fut["vacf, dos"].result()
        _dyn_close(vac[False], c_u, "vacf Water")
        _dyn_close(vac[True], c_m, "vacf Water, mass-weighted")
        hd = testing.host_dos(c_m, c_u, t_trr, float(m_w.sum()), k_w)
        for key in ("T", "dof"):
            _dyn_value(ds[key], hd[key], f"dos {key}")
        _dyn_close(ds["dos"], hd["dos"], "dos spectrum")
        check(abs(ds["dof"] - 3 * k_w) <= 1e-6 * 3 * k_w,
              f"dos: the spectrum integrates to 3N = {3 * k_w} ({ds['dof']:.3f})")

        ht = fut["tcaf"].result()
        margin = min(np.abs(row[:s + 1] - 0.3).min() for row, s in zip(ht["tcaf"], ht["stops"]))
        if margin < 1e-4:          # a point at the floor: fit over the card's prefix
            good = tc["tcaf"] > 0.3
            stops = [max(int(np.argmin(g)) if not g.all() else n_trr, 3) for g in good]
            ht = testing.host_tcaf(coords[:n_trr, wat], vel[:, wat], m_w, boxes[0], 4, 0.3,
                                   float(t_trr[1]), prefix=stops)
        e = float(np.abs(tc["tcaf"] - ht["tcaf"]).max())
        check(e <= 1e-4, f"tcaf: the normalised curves within 1e-4 of float64 ({e:.2e}; fit "
              f"prefixes {ht['stops']}, the nearest point {margin:.3f} from the floor)")
        for key in ("nu", "eta_k", "eta0"):
            _dyn_value(tc[key], ht[key], f"tcaf {key}", rel=1e-3)

        want_tot, want_mol, n_mol = fut["dipole_corr"].result()
        e = float(np.abs(dip["total"]["corr"] - want_tot).max() / abs(want_tot[0]))
        check(e <= 1e-4, f"dipole_corr total within 1e-4 of corr[0] ({e:.2e})")
        e = float(np.abs(dip["mol"]["corr"] - want_mol).max() / abs(want_mol[0]))
        check(e <= 1e-4, f"dipole_corr mol over {n_mol} molecules within 1e-4 of corr[0] "
              f"({e:.2e}; corr_time {dip['mol']['corr_time']:.3f} ps)")

        t = time.perf_counter()
        keys = {}
        _, h = D._hbond_h_matrix(system, xtc, chain, [(0, 0)], 0.35, 120.0, BATCH,
                                 "hbond_acf", keys=keys)
        host_ana = HBondAnalysis(system, chain, [(0, 0)], 0.35, 120.0)
        frame = system.copy()
        for f in (0, N_FRAMES - 1):
            frame.positions[:] = coords[f]
            frame.set_box(SimBox.from_lengths(*map(float, boxes[f])))
            bonds = host_ana.analyze(frame)[(0, 0)]
            want = {((0, 0), b.donor, b.hydrogen, b.acceptor) for b in bonds}
            got = {k for k, c in keys.items() if h[f, c]}
            check(got == want, f"hydrogen bonds of frame {f}: the {len(got)} columns present "
                  "equal the host float32 emulation's bonds")
        check(np.array_equal(D._hbond_curve(h, False), hb_acf)
              and np.array_equal(hb_acf, hb_life["intermittent"]),
              f"hbond_acf (intermittent) equals hbond_lifetime's bit for bit "
              f"({hb_life['n_bonds_seen']} bonds seen over {N_FRAMES} frames, occupancy "
              f"{hb_life['occupancy']:.4f}, tau {hb_life['tau_intermittent']:.2f} / "
              f"{hb_life['tau_continuous']:.2f} ps)")
        oracle_secs["hbonds (main thread)"] = time.perf_counter() - t

        sm = fut["filter_traj"].result()
        for w, path in paths.items():
            o, _, _, n_at = native.xtc_scan(path)
            back, _, _, _, prec = native.xtc_read_frames(path, o, n_at)
            d = back - sm
            if w == "wrap":
                d = np.stack([testing._mi(d[f], boxes[f]) for f in range(N_FRAMES)])
            gap = float(np.abs(d).max())
            tol = 0.5 / float(prec[0]) + 2 * float(np.spacing(np.float32(np.abs(back).max())))
            check(back.shape == (N_FRAMES, len(p), 3) and gap <= tol,
                  f"filter_traj ({w}): {N_FRAMES} frames of {len(p)} atoms read back within "
                  f"half of 1/precision and two ulps of float64 ({gap:.3e} <= {tol:.3e})")
            os.unlink(path)
    say(f"  oracles {time.perf_counter() - t_or:.1f} s on {ORACLE_THREADS} threads (each job's own "
        "seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in oracle_secs.items()) + ")")

    # ---- resident windows, determinism ---------------------------------------
    ta = M.TrajectoryAnalysis(system, device=dev)
    for label, dt in (("load_device(ship='all')",
                       ta.runner(ship="all").load_device(xtc, batch_size=BATCH)),
                      ("runner(group='OW')",
                       ta.runner(group="OW").load_device(xtc, batch_size=BATCH))):
        check(np.array_equal(M.msd(system, dt, "OW")[1], msd_xyz),
              f"msd over {label} equals msd from the file bit for bit")
        if label.startswith("runner"):
            try:
                M.msd(system, dt, "Water")
                refused = False
            except ParallelError:
                refused = True
            check(refused, "msd of Water over the OW window raises ParallelError")
        del dt
    for label, dt in (("load_device(ship='all')",
                       ta.runner(ship="all", velocities=True).load_device(trr, batch_size=BATCH)),
                      ("runner(group='Water')",
                       ta.runner(group="Water", velocities=True).load_device(
                           trr, batch_size=BATCH))):
        check(np.array_equal(M.vacf(system, dt, "Water", mass_weighted=True)[1], vac[True]),
              f"vacf over {label} equals vacf from the TRR bit for bit")
        del dt
    again = M.msd_mol(system, xtc, "Membrane", dims="xy", batch_size=BATCH)
    check(np.array_equal(again["msd"], mol["msd"]), "msd_mol twice: the same bits")
    again = M.vanhove(system, xtc, "Water", lags=range(1, N_FRAMES), r_max=2.0, bins=100,
                      batch_size=BATCH)
    check(np.array_equal(again["counts"], vh["counts"]), "vanhove twice: the same counts")
    os.unlink(trr)
    say(f"  phase 14 seconds: {time.perf_counter() - t_phase:.1f}")
    return counts


MEM_GRID = (100, 100)      # densmap tiles
HYD_FRAMES = 1             # frames of hydorder: O(W^2) pairs a frame (2 before phase 23, 4 before 22)
HYD_ORACLE_FRAMES = 2      # of them, the frames its float64 oracle checks
HYD_SLABS = 20


def _rel_close(got, want, what, rel):
    e = float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())
    check(e <= rel, f"{what} within {rel:g} of its largest magnitude ({e:.2e})")


def _slack_close(got, sure, slack, what):
    gap = np.abs(np.asarray(got, np.float64) - sure)
    check((gap <= slack + 1e-6).all(),
          f"{what}: equal to float64 but for {int(slack.sum() // 2)} values within float32 "
          f"reach of a bin edge (largest gap {gap.max():.3g})")


def _chunks(per_frame, n_frames):
    """Frame chunks of a call whose largest temporary holds `per_frame`
    elements a frame, at most 2^26 elements a chunk."""
    return -(-n_frames // max(1, (1 << 26) // per_frame))


def _tie_checks(torch, dev):
    """hydorder on exact ties of d^2 on the card: the four nearest of the
    centre's six equidistant neighbours are the four lowest indices."""
    from groan_rs_tpu_torch import convert
    from groan_rs_tpu_torch import models as M
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.ops import kernels as K

    axes = {"+x": [0.25, 0, 0], "-x": [-0.25, 0, 0], "+y": [0, 0.25, 0],
            "-y": [0, -0.25, 0], "+z": [0, 0, 0.25], "-z": [0, 0, -0.25]}
    box = np.float32([4.0, 4.0, 4.0])
    for order, sg in ((("+x", "+y", "-x", "-y", "+z", "-z"), 0.5),
                      (("+x", "-x", "+y", "+z", "-y", "-z"), 0.625)):
        pts = (2.0 + np.concatenate([[[0.0, 0.0, 0.0]], [axes[k] for k in order]])).astype(
            np.float32)
        path = os.path.join(K.BUILD_DIR, "smoke_tie.xtc")
        if os.path.exists(path):
            os.unlink(path)
        native.xtc_write_frame(path, 7, 0, 0.0, np.diag(box).reshape(9), pts, 1000.0)
        s = convert.system_from_state({
            "positions": pts, "box": box, "mass": np.ones(7, np.float32),
            "has_mass": np.ones(7, bool), "precision": 1000,
            "groups": {"O": np.arange(7)}}, device=dev)
        got = float(M.hydorder(s, path, "O")["sg"][0, 0])
        check(got == sg, f"hydorder on the card: the centre's four nearest of six tied are the "
              f"four lowest indices (S_g {got} == {sg}, order {' '.join(order)})")
        os.unlink(path)


def _membrane_triclinic(torch, dev):
    """`densmap` and `sorient` on phase 8's rhombic dodecahedron (12
    frames) against the triclinic float64 oracles; no kernel launches."""
    from groan_rs_tpu_torch import convert, testing
    from groan_rs_tpu_torch import models as M
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.ops import center as C
    from groan_rs_tpu_torch.ops import kernels as K

    txtc = triclinic_xtc(BATCH)
    offs, _, _, nat = native.xtc_scan(txtc)
    coords, b9s = native.xtc_read_frames(txtc, offs, nat)[:2]
    h = b9s.reshape(-1, 3, 3)
    lay = testing.synthetic_layout(nat)
    n_prot, w0 = lay["n_prot"], lay["w0"]
    n_whole = (nat - w0) // 3
    state = testing.synthetic_state(coords[0], h[0], topology="full")
    names = testing.named_layout(nat)
    state.update({k: names[k] for k in ("resnum", "resname", "atomname")})
    system = convert.system_from_state(state, device=dev)
    system.group_create_from_indices("WW", np.arange(w0, w0 + 3 * n_whole))
    K.reset_launch_counts()
    t0 = time.perf_counter()
    dm = M.densmap(system, txtc, "Water", bins=MEM_GRID, batch_size=BATCH)
    so = M.sorient(system, txtc, "Protein", oxygen="WW and name OW",
                   hydrogens="WW and name HW1 HW2", rmax=1.5, bins=40, batch_size=BATCH)
    say(f"  triclinic densmap + sorient ({len(offs)} frames): {time.perf_counter() - t0:.2f} s")
    no_launches(dict(K.launch_counts), "phase 15's triclinic calls")
    wat = system.group_indices("Water")
    counts, _, c_slack, _ = testing.host_densmap(coords[:, wat], h, 0, 1, *MEM_GRID,
                                                 np.ones(len(wat)))
    _slack_close(dm["counts"], counts, c_slack, "triclinic densmap counts")
    check(dm["counts"].sum() == len(offs) * len(wat), "triclinic densmap keeps every atom")
    p = system.topology.mass[:n_prot]
    ctr = C.center_triclinic(torch.from_numpy(coords[:, :n_prot]).to(dev),
                             torch.from_numpy(h).to(dev), weights=p).cpu().numpy()
    host = np.stack([testing.host_refined_center_triclinic(coords[f, :n_prot], h[f], p)
                     for f in range(len(offs))])
    # an atom within 1e-5 (fractional) of the unwrap boundary about the
    # float64 estimate may take the other image in float32: it moves the
    # centre by its box vector times m_i / sum m
    jump = np.zeros(len(offs))
    for f in range(len(offs)):
        sf = coords[f, :n_prot].astype(np.float64) @ np.linalg.inv(h[f])
        theta = (sf - np.floor(sf)) * 2 * np.pi
        est = (np.arctan2(-(p[:, None] * np.sin(theta)).sum(0),
                          -(p[:, None] * np.cos(theta)).sum(0)) + np.pi) / (2 * np.pi)
        d = sf - est
        near = np.abs(np.abs(d - np.round(d)) - 0.5) < 1e-5
        jump[f] = ((near * p[:, None]).sum(0) * np.linalg.norm(h[f], axis=1)).sum() / p.sum()
    delta = np.linalg.norm(ctr - host, axis=1)
    check((delta <= 1e-4 + jump).all(), f"triclinic reference centre within 1e-4 nm plus the "
          f"image changes ({delta.max():.2e}; bound {jump.max():.2e} nm)")
    o = np.arange(w0, w0 + 3 * n_whole, 3)
    want = testing.host_sorient(coords[:, o], coords[:, o + 1], coords[:, o + 2],
                                coords[:, :n_prot], p, h, 0.0, 1.5, 40, delta=delta)
    _sorient_checks(so, want, "triclinic sorient")


def _mean_slack(s_slack, n_slack, n):
    """How far a mean of cosines (sum S over count N) may move when S moves
    by `s_slack` and N by `n_slack`: (s_slack + n_slack) / (N - n_slack),
    unbounded where N - n_slack <= 0."""
    room = n - n_slack
    return np.where(room > 0, (s_slack + n_slack) / np.maximum(room, 1e-300), np.inf)


def _sorient_checks(so, want, what):
    n = so["n_selected"]
    check(abs(n - want["n"]) <= want["n_slack"] and n > 0,
          f"{what}: {n:.0f} water-frames in the shell (float64 {want['n']:.0f}, "
          f"{want['n_slack']:.0f} at its edges)")
    dc = 2.0 / len(so["cos1_hist"])
    _slack_close(so["cos1_hist"] * n * dc, want["h1"], want["h1_slack"], f"{what} cos1 counts")
    _slack_close(so["cos2_hist"] * 2 * n * dc, want["h2"], want["h2_slack"],
                 f"{what} cos2 counts")
    for key, s, div in (("mean_cos1", "s1", n), ("mean_cos2", "s2", 2 * n)):
        e = abs(so[key] - want[s] / div)
        check(e <= 1e-4 + (want[s + "_slack"] + want["n_slack"]) / div,
              f"{what} {key} {so[key]:.6f} within 1e-4 of float64 ({e:.2e})")
    ok = want["rn"] > 0
    e = np.abs(so["mean_cos1_r"][ok] - want["rs"][ok] / want["rn"][ok])
    bound = 1e-4 + _mean_slack(want["rs_slack"][ok], want["rn_slack"][ok], want["rn"][ok])
    check((e <= bound).all(), f"{what} mean_cos1_r within 1e-4 of float64 per shell, plus "
          f"what values at a shell edge or the centre's gap move it by (largest gap "
          f"{e.max():.2e}, {(e / bound).max():.3f} of its bound)")


def membrane_phase(torch, xtc, offs, nat, frame0, box, dev):
    """Phase 15: the membrane and interfacial-water analyses of
    `models/membrane.py` over phase 4's XTC -> the K1/K2/K3 launches of
    its main path (predicted: one K1 and one K2 a frame chunk of each
    `sorient` and `spol` call, no K3)."""
    from groan_rs_tpu_torch import GridMap, convert, testing
    from groan_rs_tpu_torch import models as M
    from groan_rs_tpu_torch.errors import GroupError
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.ops import center as C
    from groan_rs_tpu_torch.ops import kernels as K

    say(f"phase 15: membrane and interfacial-water analyses, {nat} atoms x {N_FRAMES} frames")
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    lay = testing.synthetic_layout(nat)
    n_prot, w0 = lay["n_prot"], lay["w0"]
    n_whole = (nat - w0) // 3
    state = testing.synthetic_state(frame0.copy(), box, topology="full")
    names = testing.named_layout(nat)
    state.update({k: names[k] for k in ("resnum", "resname", "atomname")})
    system = convert.system_from_state(state, device=dev)
    heads = np.arange(n_prot + 3, w0, testing.LIPID_SIZE)        # the lipids' P
    system.group_create_from_indices("Heads", heads)
    system.group_create_from_indices("WW", np.arange(w0, w0 + 3 * n_whole))
    ox, hy = "WW and name OW", "WW and name HW1 HW2"
    n_hyd = min(HYD_FRAMES, N_FRAMES)
    n_hyd_chk = min(HYD_ORACLE_FRAMES, n_hyd)
    hxtc = os.path.join(K.BUILD_DIR, f"smoke_hyd_{nat}_{n_hyd}.xtc")
    with open(xtc, "rb") as src, open(hxtc, "wb") as dst:   # the first frames, byte for byte
        dst.write(src.read(int(offs[n_hyd]) if n_hyd < len(offs) else -1))
    gm_path = os.path.join(K.BUILD_DIR, "smoke_densmap.dat")
    secs = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        return out

    # ---- the phase's main path: what a user calls, from the file names -----
    K.reset_launch_counts()
    t_main = time.perf_counter()
    dm = {w: timed(f"densmap Water {w}", lambda w=w: M.densmap(
        system, xtc, "Water", bins=MEM_GRID, weights=w, batch_size=BATCH))
        for w in ("number", "mass", "charge")}
    timed("GridMap save", lambda: dm["number"]["map"].save(gm_path))
    back = timed("GridMap from_file", lambda: GridMap.from_file(gm_path))
    pot = timed("potential_profile all", lambda: M.potential_profile(
        system, xtc, "all", n_bins=100, batch_size=BATCH))
    order = timed("order_parameters Membrane", lambda: M.order_parameters(
        system, xtc, "Membrane", batch_size=BATCH))
    dens = timed("densorder Membrane", lambda: M.densorder(
        system, xtc, "Membrane", bins=100, mode="mass", threshold=0.5, batch_size=BATCH))
    leaf = timed("leaflets Heads", lambda: M.leaflets(system, xtc, "Heads", batch_size=BATCH))
    h2 = timed("h2order", lambda: M.h2order(system, xtc, oxygen=ox, hydrogens=hy, bins=50,
                                            batch_size=BATCH))
    so = timed("sorient", lambda: M.sorient(system, xtc, "Protein", oxygen=ox, hydrogens=hy,
                                            rmax=1.5, bins=40, batch_size=BATCH))
    sp = timed("spol", lambda: M.spol(system, xtc, "Protein", "WW", rmax=1.5, bins=50,
                                      batch_size=BATCH))
    hyd = timed(f"hydorder ({n_hyd} frames)", lambda: M.hydorder(
        system, hxtc, ox, slabs=HYD_SLABS, batch_size=BATCH))
    t_main = time.perf_counter() - t_main
    counts = dict(K.launch_counts)
    say("  seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    say(f"  the phase's main path: {t_main:.2f} s")
    if cuda:
        say(f"  max_memory_allocated over the main path: "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    # sorient: [F, W, 3] temporaries; spol: [F, W, 3, 3] (W whole waters)
    n_ctr = _chunks(3 * max(n_whole, n_prot), N_FRAMES) + _chunks(9 * n_whole, N_FRAMES)
    predicted = {"bai_breen_estimate": n_ctr, "bai_breen_refine": n_ctr, "pair_reduce": 0}
    say(f"  launches {counts}, predicted {predicted}")
    if cuda:
        check(counts == predicted, "K1, K2 and K3 launched as the code predicts")
    else:
        no_launches(counts, "phase 15 on the CPU")

    # ---- the reader's refusals --------------------------------------------
    try:
        M.sorient(system, xtc, "Protein", oxygen="name OW", hydrogens="name HW1 HW2")
        code = None
    except GroupError as e:
        code = e.code
    check(code == "InvalidWater", "sorient over 'name OW' (the layout's last water is a "
          f"lone OW) raises GroupError InvalidWater ({code})")

    # ---- against float64 oracles --------------------------------------------
    t_or = time.perf_counter()
    coords, b9s = native.xtc_read_frames(xtc, offs[:N_FRAMES], nat)[:2]
    boxes = b9s[:, [0, 4, 8]].astype(np.float64)
    wat, mem = system.group_indices("Water"), system.group_indices("Membrane")
    mass, q = system.topology.mass, system.topology.charge
    o = np.arange(w0, w0 + 3 * n_whole, 3)
    c_idx, h_idx = order["pairs"]
    w_prot = mass[:n_prot]
    # the reference centre on the card (K1 + K2, outside the main path's count)
    # against float64: within 1e-4 nm plus the jumps of the atoms whose
    # unwrap image differs between the card's estimate and float64's
    # (each moves the mass-weighted centre by L m_i / sum m)
    p_dev = torch.from_numpy(coords[:, :n_prot]).to(dev)
    b_dev = torch.from_numpy(boxes.astype(np.float32)).to(dev)
    ctr = C.center(p_dev, b_dev, weights=w_prot).cpu().numpy()
    est = K.bai_breen_estimate(p_dev, None, b_dev).cpu().numpy()
    del p_dev
    host_ctr = np.stack([testing.host_refined_center(coords[f, :n_prot], boxes[f], w_prot)
                         for f in range(N_FRAMES)])
    jump = np.zeros((N_FRAMES, 3))
    n_jump = 0
    for f in range(N_FRAMES):
        p, bl = coords[f, :n_prot], boxes[f]
        theta = np.mod(p.astype(np.float64), bl) * (2 * np.pi / bl)
        est_h = (np.arctan2(-np.sin(theta).sum(0), -np.cos(theta).sum(0)) + np.pi) \
            * bl / (2 * np.pi)
        b32 = bl.astype(np.float32)
        img_k = np.floor((p - est[f] + b32 * np.float32(0.5)) / b32)
        img_h = np.floor((p - est_h + bl / 2) / bl)
        moved = img_k != img_h
        n_jump += int(moved.sum())
        jump[f] = (moved * w_prot[:, None]).sum(0) * bl / w_prot.sum()
    gap = np.abs(ctr - host_ctr)
    delta = np.linalg.norm(ctr - host_ctr, axis=1)
    check((gap <= 1e-4 + jump).all(), f"the Protein's refined centre (K1 + K2) within 1e-4 nm "
          f"of float64 on every frame, plus the image changes ({gap.max():.2e}; {n_jump} atom "
          f"coordinates change image, bound {jump.max():.2e} nm)")
    oracle_secs = {}

    def dm_oracle(wname):
        w = {"number": np.ones(len(wat)), "mass": mass[wat], "charge": q[wat]}[wname]
        return testing.host_densmap(coords[:, wat], boxes, 0, 1, *MEM_GRID,
                                    w.astype(np.float32))

    def dm_bounds():
        span = ((0.0, float(boxes[0, 0])), (0.0, float(boxes[0, 1])))
        lo = hi = 0
        for f in range(N_FRAMES):
            a, b = testing.host_density_map(np.mod(coords[f, wat], boxes[f]), (0, 1), span,
                                            *MEM_GRID)
            lo, hi = lo + a, hi + b
        return lo, hi

    def densorder_oracle():
        prof = np.stack([testing.host_density_profile(coords[f, mem], boxes[f], 2, 100,
                                                      mass[mem], 1.66053906660)
                         for f in range(N_FRAMES)])
        return testing.host_interfaces(prof, boxes[:, 2], 0.5)

    def hyd_oracle():
        return [testing.host_hydorder(coords[f, o], boxes[f]) for f in range(n_hyd_chk)]

    def spol_oracle():
        g = np.stack([o, o + 1, o + 2], 1)
        m = mass[g].astype(np.float64)
        return testing.host_spol(coords[:, g], m / m.sum(1, keepdims=True), q[g],
                                 coords[:, :n_prot], w_prot, boxes, 1.5, 50, delta=delta)

    jobs = {
        **{f"densmap {w}": (lambda w=w: dm_oracle(w)) for w in ("number", "mass", "charge")},
        "densmap bounds": dm_bounds,
        "potential": lambda: testing.host_potential(coords, boxes, q, 2, 100),
        "order": lambda: np.mean([testing.host_order(coords[f, c_idx], coords[f, h_idx],
                                                     boxes[f], [0, 0, 1])
                                  for f in range(N_FRAMES)], axis=0),
        "densorder": densorder_oracle,
        "leaflets": lambda: testing.host_leaflets(coords[:, heads, 2], boxes[:, 2]),
        "h2order": lambda: testing.host_h2order(coords[:, o], coords[:, o + 1],
                                                coords[:, o + 2], boxes, 2, 50),
        "sorient": lambda: testing.host_sorient(coords[:, o], coords[:, o + 1],
                                                coords[:, o + 2], coords[:, :n_prot], w_prot,
                                                boxes, 0.0, 1.5, 40, delta=delta),
        "spol": spol_oracle,
        "hydorder": hyd_oracle,
    }

    def timed_job(name, fn):
        t = time.perf_counter()
        out = fn()
        oracle_secs[name] = time.perf_counter() - t
        return out

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=ORACLE_THREADS) as pool:
        fut = {k: pool.submit(timed_job, k, fn) for k, fn in jobs.items()}

        for wname in ("number", "mass", "charge"):
            counts_h, dens_h, _, _ = fut[f"densmap {wname}"].result()
            got = dm[wname]
            if wname == "number":
                check(np.array_equal(got["counts"], counts_h),
                      f"densmap counts of the {len(wat)} water atoms equal float64's "
                      f"(the device's float32 tile rule) over {MEM_GRID[0]}x{MEM_GRID[1]} tiles")
                lo, hi = fut["densmap bounds"].result()
                check(((lo <= got["counts"]) & (got["counts"] <= hi)).all(),
                      "densmap counts within testing.host_density_map's edge bounds "
                      f"(hi - lo summed over the tiles: {int((hi - lo).sum())}; the tile "
                      "edges lie on the file's 0.001 nm grid)")
                big = int(got["counts"].max())
                say(f"  densmap: the fullest tile holds {big} atom-frames "
                    f"({'above' if big > 2 ** 24 else 'below'} 2^24 = {2 ** 24})")
            else:
                _rel_close(got["counts"], counts_h, f"densmap {wname} counts", 1e-5)
            _rel_close(got["density"], dens_h, f"densmap {wname} density", 1e-5)
        check(np.array_equal(back.values, dm["number"]["map"].values)
              and back.n_tiles() == MEM_GRID[0] * MEM_GRID[1],
              "the densmap GridMap reads back from its text file equal")

        want = fut["potential"].result()
        _rel_close(pot["rho"], want["rho"], f"potential_profile rho of all {nat} atoms", 1e-4)
        # field and psi are cumulative sums of rho in float64 on the host, as
        # the oracle's: of a neutral system, small differences of large sums,
        # so they are held to what rho's float32 gap moves them by
        bounds = testing.potential_gap_bound(pot["rho"] - want["rho"], float(boxes[0, 2]), 100)
        for k, bound in zip(("field", "psi"), bounds):
            gap = np.abs(pot[k] - want[k])
            check((gap <= bound).all(), f"potential_profile {k} within what rho's float32 gap "
                  f"moves it by ({gap.max() / np.abs(want[k]).max():.2e} of its largest, "
                  f"{(gap / bound).max():.3f} of the bound)")

        want = fut["order"].result()
        e = float(np.abs(order["s_pairs"] - want).max())
        check(len(c_idx) == len(lay["lipid_hydrogens"]) and e <= 1e-4,
              f"order_parameters: the {len(c_idx)} C-H bonds within 1e-4 of float64 ({e:.2e})")

        lower, upper = fut["densorder"].result()
        e = max(float(np.abs(dens["lower"] - lower).max()),
                float(np.abs(dens["upper"] - upper).max()))
        check(np.isfinite(dens["thickness"]).all() and (dens["lower"] < dens["upper"]).all()
              and e <= 1e-3, f"densorder: two interfaces a frame within 1e-3 nm of float64 "
              f"({e:.2e}; mean {dens['lower'].mean():.3f} / {dens['upper'].mean():.3f} nm)")

        lf, thick, center, near = fut["leaflets"].result()
        same = (leaf["leaflet"] == lf) | near
        e = max(float(np.abs(leaf["thickness"] - thick).max()),
                float(np.abs(leaf["center"] - center).max()))
        check(same.all() and e <= 1e-4,
              f"leaflets: the {len(heads)} heads' signs equal float64's ({int(near.sum())} "
              f"within 1e-5 nm of the centre), thickness and centre within 1e-4 nm ({e:.2e}; "
              f"upper {int((leaf['leaflet'] > 0).sum())} of {leaf['leaflet'].size})")

        want = fut["h2order"].result()
        ok = want["cn"] > 0
        e = float(np.abs(h2["cos"][ok] - want["cs"][ok] / want["cn"][ok]).max())
        check(np.array_equal(h2["count"], want["cn"]) and h2["count"].sum() == N_FRAMES * n_whole
              and e <= 1e-4, f"h2order: slab counts equal float64's, {n_whole} waters a "
              f"frame, mean cosines within 1e-4 ({e:.2e})")

        _sorient_checks(so, fut["sorient"].result(), "sorient")

        want = fut["spol"].result()
        _slack_close(sp["counts"], want["cn"], want["cn_slack"], "spol shell counts")
        ok = want["cn"] > 0
        e = np.abs(sp["mean_cos_r"][ok] - want["cs"][ok] / want["cn"][ok])
        bound = 1e-4 + _mean_slack(want["cs_slack"][ok], want["cn_slack"][ok], want["cn"][ok])
        check((e <= bound).all(), f"spol: per-shell mean cosines within 1e-4 of float64, plus "
              f"what molecules at a shell edge or the centre's gap move them by (largest gap "
              f"{e.max():.2e}, {(e / bound).max():.3f} of its bound; {sp['n_selected']:.0f} "
              "molecule-frames in 1.5 nm)")

        tied_n = 0
        for f, (sg, sk, tied) in enumerate(fut["hydorder"].result()):
            e = max(float(np.abs(hyd["sg"][f][~tied] - sg[~tied]).max()),
                    float(np.abs(hyd["sk"][f][~tied] - sk[~tied]).max()))
            tied_n += int(tied.sum())
            check(e <= 1e-4, f"hydorder frame {f}: S_g and S_k of {int((~tied).sum())} "
                  f"oxygens within 1e-4 of the periodic cKDTree's ({e:.2e})")
        check(hyd["slab_counts"].sum() == n_hyd * n_whole,
              f"hydorder: {HYD_SLABS} slabs hold every oxygen of its {n_hyd} frames "
              f"({tied_n} oxygens of frames 0-{n_hyd_chk - 1} excused for a 4th/5th "
              "neighbour tie within 1e-5 nm)")
    say(f"  oracles {time.perf_counter() - t_or:.1f} s on {ORACLE_THREADS} threads (each job's own "
        "seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in oracle_secs.items()) + ")")

    # ---- resident windows, determinism ---------------------------------------
    t0 = time.perf_counter()
    ta = M.TrajectoryAnalysis(system, device=dev)
    dt = ta.runner(ship="all").load_device(xtc, batch_size=BATCH)
    for label, again in (("over load_device(ship='all')", M.sorient(
            system, dt, "Protein", oxygen=ox, hydrogens=hy, rmax=1.5, bins=40)),
                         ("twice", M.sorient(system, xtc, "Protein", oxygen=ox, hydrogens=hy,
                                             rmax=1.5, bins=40, batch_size=BATCH))):
        check(all(np.array_equal(so[k], again[k], equal_nan=True) for k in so),
              f"sorient {label}: the file call's bits")
    del dt
    hdt = ta.runner(ship="all").load_device(hxtc, batch_size=BATCH)
    t1 = time.perf_counter()
    again = M.hydorder(system, hdt, ox, slabs=HYD_SLABS)
    if cuda:
        torch.cuda.synchronize()
    t_hyd = (time.perf_counter() - t1) / n_hyd
    check(all(np.array_equal(hyd[k], again[k]) for k in hyd),
          "hydorder over load_device(ship='all'): the file call's bits")
    again = M.hydorder(system, hxtc, ox, slabs=HYD_SLABS, batch_size=BATCH)
    check(all(np.array_equal(hyd[k], again[k]) for k in hyd), "hydorder twice: the same bits")
    del hdt
    # the least time of one frame: W^2 pairs x 25 FP32 instructions (3 subtractions,
    # 3 x 5 of the minimum image, 5 of d^2, 2 of the running top-4) over 3.35e13/s
    bound_ms = n_whole ** 2 * 25 / 3.35e13 * 1e3
    say(f"  hydorder of one resident frame ({n_whole} oxygens, {n_whole ** 2:.3e} pairs): "
        f"{1e3 * t_hyd:.1f} ms, bound {bound_ms:.1f} ms (operations) = "
        f"{100 * bound_ms / (1e3 * t_hyd):.2f}%")
    say(f"  windows and repeats: {time.perf_counter() - t0:.1f} s")
    for path in (hxtc, gm_path):
        os.unlink(path)

    # ---- the card's tie rule, the triclinic forms ------------------------------
    _tie_checks(torch, dev)
    _membrane_triclinic(torch, dev)
    say(f"  phase 15 seconds: {time.perf_counter() - t_phase:.1f}")
    return counts


GEO_FRAMES = 1          # frames of the dense pair analyses (sasa, select, trjorder, pairdist; 2 before phase 23, 4 before 22)
FREEVOL_FRAMES = 4      # frames of freevolume (8 before phase 22)
PI_PROTEIN_FRAMES = 1   # frames of pi_mindist over the Protein (2 before phase 22)
# of those frames, the first ones that the float64 oracles check
GEO_ORACLE_FRAMES, FREEVOL_ORACLE_FRAMES, PI_PROTEIN_ORACLE_FRAMES = 2, 4, 1
TRI_FRAMES = 2          # dodecahedron frames of the triclinic sasa, freevolume and select
SASA_CAP = 128          # max_neighbors that holds on the synthetic Protein
SASA_SMALL_CAP = 64     # the JAX default, too small for it: sasa raises
SASA_SAMPLE = 500       # atoms a frame whose SASA the float64 oracle computes
SALT_RESIDUES = 1000    # Protein residues of saltbr
MIN_RESIDUES = 500      # residues on each side of pairdist(mode="min")
GEO_TOL = 1e-4          # nm (and cosines): float32 of 1M-atom coordinates against float64
TRJ_TOL = 1e-5          # nm: trjorder's distances (pairdist's tolerance in the JAX tests)


def _frame_copy(xtc, offs, n, tag):
    """The first `n` frames of `xtc`, byte for byte, in the build directory."""
    from groan_rs_tpu_torch.ops import kernels as K

    path = os.path.join(K.BUILD_DIR, f"smoke_geo_{tag}_{n}.xtc")
    with open(xtc, "rb") as src, open(path, "wb") as dst:
        dst.write(src.read(int(offs[n]) if n < len(offs) else -1))
    return path


def _geometry_system(frame0, box, dev):
    """Phase 14's full topology with `testing.named_layout`'s residues and
    names, guessed elements and vdW radii, the layout's bonds, and Protein
    charges of +1 on every LYS/ARG residue and -1 on every ASP/GLU residue
    (on its N), zero elsewhere -> (System, charged residue names)."""
    import warnings

    from groan_rs_tpu_torch import convert, testing

    state = testing.synthetic_state(frame0.copy(), box, topology="full")
    names = testing.named_layout(frame0.shape[0])
    state.update({k: names[k] for k in ("resnum", "resname", "atomname")})
    n_prot = testing.synthetic_layout(frame0.shape[0])["n_prot"]
    q = state["charge"].copy()
    q[:n_prot] = 0.0
    first = np.arange(0, n_prot, testing.RESIDUE_SIZE)
    rn = names["resname"][first]
    q[first] = np.where(np.isin(rn, ("LYS", "ARG")), 1.0,
                        np.where(np.isin(rn, ("ASP", "GLU")), -1.0, 0.0))
    state["charge"] = q
    system = convert.system_from_state(state, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        system.guess_elements()
    return system


def _chi_on_card(dev):
    """`models.chi` on ideal residues with full side chains
    (`testing.chi_state`: every alternative of the chi site table) on the
    card against the placed angles and float64 dihedrals."""
    from groan_rs_tpu_torch import convert, testing
    from groan_rs_tpu_torch import models as M
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.ops import kernels as K

    st = testing.chi_state(20, 4)
    frames = st["frames"].astype(np.float32)
    path = os.path.join(K.BUILD_DIR, "smoke_chi.xtc")
    if os.path.exists(path):
        os.unlink(path)
    for f in range(frames.shape[0]):
        native.xtc_write_frame(path, frames.shape[1], f, float(f),
                               np.diag(st["box"]).astype(np.float32).reshape(9), frames[f],
                               100000.0)
    n = frames.shape[1]
    system = convert.system_from_state({
        "positions": frames[0], "box": st["box"].astype(np.float32),
        "mass": np.ones(n, np.float32), "has_mass": np.ones(n, bool), "precision": 100000,
        "atomname": st["atomname"], "resname": st["resname"], "resnum": st["resnum"],
        "groups": {}}, device=dev)
    out = M.chi(system, path, "all", max_chi=4)
    q = native.xtc_read_frames(path, native.xtc_scan(path)[0], n)[0].astype(np.float64)
    for k in range(1, 5):
        got = out[f"chi{k}"]
        placed = np.abs((got - st["chi"][k] + 180.0) % 360.0 - 180.0).max()
        host = testing.dihedrals_host_f64(*(q[:, st["sites"][k][:, i]] for i in range(4)),
                                          np.repeat(st["box"][None], q.shape[0], 0))
        e = np.abs((got - host + 180.0) % 360.0 - 180.0).max()
        # the placed angles: the XTC's 1e-5 nm grid moves each atom by up to
        # 8.7e-6 nm, 3.5e-3 deg over a 0.14 nm lever arm, four atoms a site
        check(got.shape == st["chi"][k].shape and e <= 2e-2 and placed <= 3e-2,
              f"chi{k} on the card: {got.shape[1]} residues x {got.shape[0]} frames within "
              f"2e-2 deg of float64 ({e:.2e}) and 3e-2 of the placed angles ({placed:.2e})")
    os.unlink(path)


def geometry_phase(torch, xtc, offs, nat, frame0, box, dev, tri_site=None):
    """Phase 16: the geometric and surface analyses of `models/geometry.py`
    over phase 4's XTC -> the K1/K2/K3 launches of its main path (predicted:
    one K1 and one K2 a frame chunk of each `sdf` call, plus one each for
    frame 0's centre when it fits; no K3)."""
    from concurrent.futures import ThreadPoolExecutor

    from groan_rs_tpu_torch import testing
    from groan_rs_tpu_torch import models as M
    from groan_rs_tpu_torch.core.dimension import Dimension
    from groan_rs_tpu_torch.core.shapes import Cylinder
    from groan_rs_tpu_torch.errors import ParallelError
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.ops import center as C
    from groan_rs_tpu_torch.ops import kernels as K
    from groan_rs_tpu_torch.ops import sasa as sasa_ops
    from groan_rs_tpu_torch.utils import threefry

    say(f"phase 16: geometric and surface analyses, {nat} atoms x {N_FRAMES} frames")
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    lay = testing.synthetic_layout(nat)
    n_prot, w0 = lay["n_prot"], lay["w0"]
    n_whole = (nat - w0) // 3
    system = _geometry_system(frame0, box, dev)
    system.group_create_from_indices("WW", np.arange(w0, w0 + 3 * n_whole))
    system.group_create("OW", "Water and name OW")
    system.group_create("CA", "Protein and name CA")
    system.group_create("PN", "Protein and name N")
    n_res = n_prot // testing.RESIDUE_SIZE
    n_axes = max(a for a in range(1, 21) if n_res % a == 0)   # 20 at 1M atoms
    salt_atoms = min(SALT_RESIDUES, n_res) * testing.RESIDUE_SIZE
    system.group_create_from_indices("Salt", np.arange(salt_atoms))
    half = min(MIN_RESIDUES, n_res // 2) * testing.RESIDUE_SIZE
    system.group_create_from_indices("MinA", np.arange(half))
    system.group_create_from_indices("MinB", np.arange(half, 2 * half))
    check(system.topology.has_vdw.all(), "guess_elements gives every atom a vdW radius")
    n_geo = min(GEO_FRAMES, N_FRAMES)
    n_geo_chk = min(GEO_ORACLE_FRAMES, n_geo)
    gxtc = _frame_copy(xtc, offs, n_geo, "dense")
    fxtc = _frame_copy(xtc, offs, min(FREEVOL_FRAMES, N_FRAMES), "free")
    one = _frame_copy(xtc, offs, 1, "one")
    times = native.xtc_scan(xtc)[2]
    secs = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        return out

    # the cap: frame 0's largest relevant-neighbour count, then sasa raises
    # exactly below it (the JAX default of 64 among the caps tried)
    p0 = torch.from_numpy(native.xtc_read_frames(one, offs[:1], nat, stop_after=n_prot)[0])
    _, n_rel = sasa_ops.sasa_frames(p0.to(dev), torch.from_numpy(box[None]).to(dev),
                                    system.topology.vdw[:n_prot], max_neighbors=SASA_CAP)
    del p0
    say(f"  sasa: the largest relevant-neighbour count of frame 0's {n_prot} Protein atoms "
        f"is {n_rel}")
    for cap in sorted({SASA_SMALL_CAP, n_rel - 1, n_rel}):
        try:
            M.sasa(system, one, "Protein", max_neighbors=cap, batch_size=BATCH)
            cap_err = None
        except ParallelError as e:
            cap_err = str(e)
        want = cap < n_rel
        check((cap_err is not None) == want and (not want or f"had {n_rel} relevant" in cap_err),
              f"sasa at max_neighbors={cap} {'raises ParallelError' if want else 'holds'} "
              f"({cap_err})")
    check(n_rel <= SASA_CAP, f"the main path's max_neighbors={SASA_CAP} holds ({n_rel})")

    # ---- the phase's main path: what a user calls, from the file names -----
    K.reset_launch_counts()
    t_main = time.perf_counter()
    sa = timed(f"sasa Protein ({n_geo} frames)", lambda: M.sasa(
        system, gxtc, "Protein", max_neighbors=SASA_CAP, batch_size=BATCH))
    n_free = min(FREEVOL_FRAMES, N_FRAMES)
    fv = timed(f"freevolume all ({n_free} frames)", lambda: M.freevolume(
        system, fxtc, "all", n_samples=8192, seed=0, batch_size=BATCH))
    pts = threefry.uniform(1, (n_free, 8192, 3))
    fvp = timed("freevolume all points=", lambda: M.freevolume(
        system, fxtc, "all", points=pts, batch_size=BATCH))
    sdfs = {(w, fit): timed(f"sdf OW {w} fit={fit}", lambda w=w, fit=fit: M.sdf(
        system, xtc, "OW", "Protein", side=4.0, bins=40, fit=fit, weights=w,
        batch_size=BATCH)) for w in ("number", "mass") for fit in (False, True)}
    ps = timed("polystat Membrane", lambda: M.polystat(system, xtc, "Membrane",
                                                       batch_size=BATCH))
    hx = timed("helixorient CA", lambda: M.helixorient(system, xtc, "CA", batch_size=BATCH))
    bu = timed(f"bundle {n_axes} segments", lambda: M.bundle(
        system, xtc, "CA", "PN", n_axes=n_axes, batch_size=BATCH))
    dye = (f"serial 1 5", f"serial {n_prot // 2 + 1} {n_prot // 2 + 5}")
    dy = timed("dyecoupl", lambda: M.dyecoupl(system, xtc, *dye, r0=5.0, batch_size=BATCH))
    ga = {(g1, g2): timed(f"gangle {g1} {g2}", lambda g1=g1, g2=g2: M.gangle(
        system, xtc, "WW" if g1 == "plane" else "WW and name OW HW1", g1=g1, g2=g2,
        batch_size=BATCH)) for g1 in ("vector", "plane") for g2 in ("z", "t0")}
    pdc = timed(f"pairdist com Protein x POPC ({n_geo} frames)", lambda: M.pairdist(
        system, gxtc, "Protein", "Membrane", mode="com", batch_size=BATCH))
    pdm = timed(f"pairdist min {2 * half // 10} residues ({n_geo} frames)", lambda: M.pairdist(
        system, gxtc, "MinA", "MinB", mode="min", batch_size=BATCH))
    sb = timed("saltbr", lambda: M.saltbr(system, xtc, "Salt", batch_size=BATCH))
    sel = timed(f"select within 0.35 whole_res ({n_geo} frames)", lambda: M.select_dynamic(
        system, gxtc, "Water", within=0.35, of="Protein", whole_res=True, batch_size=BATCH))
    cyl = Cylinder(*testing.cylinder_args(box), Dimension.Z)
    sc = timed("select cylinder", lambda: M.select_dynamic(
        system, xtc, "Water", shape=cyl, batch_size=BATCH))
    tro = {m: timed(f"trjorder {m} ({n_geo} frames)", lambda m=m: M.trjorder(
        system, gxtc, "Protein", "WW", mode=m, shell=0.5, batch_size=BATCH))
        for m in ("atom", "min", "com")}
    out_xtc = os.path.join(os.path.dirname(gxtc), "smoke_trjorder_out.xtc")
    if os.path.exists(out_xtc):
        os.unlink(out_xtc)
    trw = timed("trjorder atom output=", lambda: M.trjorder(
        system, gxtc, "Protein", "WW", mode="atom", output=out_xtc, batch_size=BATCH))
    pip = timed("pi_mindist Peptide", lambda: M.pi_mindist(system, xtc, "Peptide",
                                                           batch_size=BATCH))
    n_pi = min(PI_PROTEIN_FRAMES, N_FRAMES)
    n_free_chk = min(FREEVOL_ORACLE_FRAMES, n_free)
    n_pi_chk = min(PI_PROTEIN_ORACLE_FRAMES, n_pi)
    pir = timed(f"pi_mindist Protein ({n_pi} frames)", lambda: M.pi_mindist(
        system, xtc, "Protein", end_time=float(times[n_pi - 1]), batch_size=BATCH))
    t_main = time.perf_counter() - t_main
    counts = dict(K.launch_counts)
    say("  seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    say(f"  the phase's main path: {t_main:.2f} s")
    if cuda:
        say(f"  max_memory_allocated over the main path: "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    # the least time of each dense pair analysis: its pairs x FP32
    # instructions over 3.35e13/s (132 SMs x 128 lanes x 1.98 GHz).  An
    # orthorhombic |min image|^2 is 23 instructions (3 subtractions, 3 x 5
    # of the image, 5 of the square sum); then sasa +4 (sqrt, the radius
    # sum, compare, select), freevolume +2, select and trjorder +1 (the
    # running minimum); pi_mindist 9 a shift (3 adds, 3 products, 2 sums,
    # the minimum) x 26 shifts + 8 of the internal distance
    n_sol = 3 * n_whole
    pair_work = {
        f"sasa Protein ({n_geo} frames)": (n_prot * n_prot, n_geo, 27),
        f"freevolume all ({n_free} frames)": (8192 * nat, n_free, 25),
        f"select within 0.35 whole_res ({n_geo} frames)": ((nat - w0) * n_prot, n_geo, 24),
        f"trjorder atom ({n_geo} frames)": (n_whole * n_prot, n_geo, 24),
        f"trjorder min ({n_geo} frames)": (n_sol * n_prot, n_geo, 24),
        f"trjorder com ({n_geo} frames)": (n_whole * n_prot, n_geo, 24),
        f"pi_mindist Protein ({n_pi} frames)": (n_prot * n_prot, n_pi, 9 * 26 + 8)}
    pair_s = 0.0
    for name, (pairs, frames, ops) in pair_work.items():
        bound = pairs * frames * ops / 3.35e13
        pair_s += secs[name]
        say(f"  {name}: {pairs:.3e} pairs a frame, {ops} FP32 instructions a pair, bound "
            f"{1e3 * bound:.1f} ms, measured {secs[name]:.2f} s = {100 * bound / secs[name]:.2f}% "
            f"of bound, {100 * secs[name] / t_main:.1f}% of the main path")
    say(f"  the dense pair analyses: {pair_s:.2f} s = {100 * pair_s / t_main:.1f}% of the "
        "main path")
    n_ow = int(system.group_indices("OW").size)
    n_ctr = 4 * _chunks(3 * max(n_ow, n_prot), N_FRAMES) + 2
    predicted = {"bai_breen_estimate": n_ctr, "bai_breen_refine": n_ctr, "pair_reduce": 0}
    say(f"  launches {counts}, predicted {predicted}")
    if cuda:
        check(counts == predicted, "K1, K2 and K3 launched as the code predicts")
    else:
        no_launches(counts, "phase 16 on the CPU")

    # ---- against float64 oracles --------------------------------------------
    t_or = time.perf_counter()
    coords, b9s = native.xtc_read_frames(xtc, offs[:N_FRAMES], nat)[:2]
    boxes = b9s[:, [0, 4, 8]].astype(np.float64)
    mass = system.topology.mass.astype(np.float64)
    vdw = system.topology.vdw.astype(np.float64)
    prot = np.arange(n_prot)
    ow = system.group_indices("OW")
    # the reference centre on the card (K1 + K2, outside the main path's count)
    p_dev = torch.from_numpy(coords[:, :n_prot]).to(dev)
    ctr = C.center(p_dev, torch.from_numpy(boxes.astype(np.float32)).to(dev),
                   weights=mass[:n_prot].astype(np.float32)).cpu().numpy()
    del p_dev
    rng = np.random.default_rng(16)
    rows = np.sort(rng.choice(n_prot, min(SASA_SAMPLE, n_prot), replace=False))
    oracle_secs = {}

    def timed_job(name, fn):
        t = time.perf_counter()
        r = fn()
        oracle_secs[name] = time.perf_counter() - t
        return r

    def sasa_oracle():
        return [testing.host_sasa(coords[f, :n_prot], boxes[f], vdw[:n_prot] + 0.14, rows)
                for f in range(n_geo_chk)]

    def free_oracle(u):
        return [testing.host_free_points(u[f] * boxes[f].astype(np.float32), coords[f],
                                         boxes[f], vdw)
                for f in range(n_free_chk)]

    def sdf_oracle(w, fit):
        sure, near_w, near_n = np.zeros(40 ** 3), 0.0, 0
        ref0 = testing._mi(coords[0, :n_prot] - ctr[0].astype(np.float64), boxes[0])
        for f in range(N_FRAMES):
            off = testing._mi(coords[f, ow] - ctr[f].astype(np.float64), boxes[f])
            if fit:
                cur = testing._mi(coords[f, :n_prot] - ctr[f].astype(np.float64), boxes[f])
                off = off @ testing.host_kabsch(cur, ref0, mass[:n_prot])[1].T
            a, b, c = testing.host_sdf(off, 1.0 if w == "number" else mass[ow], 4.0, 40, 2e-5)
            sure, near_w, near_n = sure + a, near_w + b, near_n + c
        return sure, near_w, near_n

    def unit_tables(blocks):
        cols = np.stack(blocks)
        w = mass[cols]
        return cols, w / w.sum(1, keepdims=True)

    res_cols, res_w = unit_tables(np.arange(n_prot).reshape(-1, testing.RESIDUE_SIZE))
    mem_cols, mem_w = unit_tables(system.group_indices("Membrane").reshape(
        -1, testing.LIPID_SIZE))

    def pairdist_oracle():
        sample = np.arange(0, res_cols.shape[0], max(1, res_cols.shape[0] // 200))
        out = []
        for f in range(n_geo_chk):
            a = testing.host_unit_means(coords[f], res_cols[sample], res_w[sample], boxes[f])
            b = testing.host_unit_means(coords[f], mem_cols, mem_w, boxes[f])
            d = testing._mi(a[:, None] - b[None], boxes[f])
            out.append(np.sqrt((d * d).sum(-1)))
        return sample, np.stack(out)

    def trjorder_oracle():
        sol = np.arange(w0, w0 + 3 * n_whole).reshape(-1, 3)
        sc, sw = unit_tables(list(sol))
        out = {"atom": [], "min": [], "com": []}
        for f in range(n_geo_chk):
            p, bx = coords[f], boxes[f]
            out["atom"].append(testing.host_nearest(p[sol[:, 0]], p[:n_prot], bx))
            out["min"].append(testing.host_nearest(p[sol.reshape(-1)], p[:n_prot], bx)
                              .reshape(-1, 3).min(1))
            out["com"].append(testing.host_nearest(testing.host_unit_means(p, sc, sw, bx),
                                                   p[:n_prot], bx))
        return {k: np.stack(v) for k, v in out.items()}

    jobs = {
        "sasa": sasa_oracle,
        "freevolume": lambda: free_oracle(threefry.uniform(0, (n_free, 8192, 3))),
        "freevolume points": lambda: free_oracle(pts),
        **{f"sdf {w} {fit}": (lambda w=w, fit=fit: sdf_oracle(w, fit))
           for w in ("number", "mass") for fit in (False, True)},
        "polystat": lambda: testing.host_polystat(
            coords, mem_cols, np.full(mem_cols.shape[0], testing.LIPID_SIZE),
            np.ones(mem_cols.shape), boxes),
        "pairdist com": pairdist_oracle,
        "pairdist min": lambda: [testing.host_residue_min(
            coords[f], boxes[f], list(np.arange(2 * half).reshape(-1, testing.RESIDUE_SIZE)))
            for f in range(n_geo_chk)],
        "select": lambda: [testing.host_nearest(coords[f, w0:], coords[f, :n_prot], boxes[f])
                           for f in range(n_geo_chk)],
        "trjorder": trjorder_oracle,
        "pi Peptide": lambda: [testing.host_self_image(coords[f, :400], np.diag(boxes[f]))
                               for f in range(N_FRAMES)],
        "pi Protein": lambda: [testing.host_self_image(coords[f, :n_prot], np.diag(boxes[f]))
                               for f in range(n_pi_chk)],
    }
    with ThreadPoolExecutor(max_workers=ORACLE_THREADS) as pool:
        fut = {k: pool.submit(timed_job, k, fn) for k, fn in jobs.items()}

        # sasa over a sample of the Protein
        worst, n_slack, n_max = 0.0, 0, 0
        for f, (area, count, slack) in enumerate(fut["sasa"].result()):
            gap = np.abs(sa["area"][f, rows] - area)
            bound = slack + 2e-6 * area + 1e-6
            worst = max(worst, float((gap / bound).max()))
            n_slack += int((slack > 0).sum())
            n_max = max(n_max, int(count.max()))
        check(worst <= 1.0, f"sasa: {len(rows)} sampled atoms x frames 0-{n_geo_chk - 1} of "
              f"{n_geo} within float64 "
              f"but for test points within 2e-5 nm of a sphere ({n_slack} atom-frames with "
              f"such points; largest gap {worst:.3f} of its bound); the largest relevant "
              f"count of the sample {n_max} <= max_neighbors {SASA_CAP}")
        say(f"  sasa: total per frame {sa['total']}")

        for name, got in (("freevolume", fv), ("freevolume points", fvp)):
            res = fut[name].result()
            sure = np.asarray([fr.mean() for fr, _ in res])
            near = np.asarray([nr.mean() for _, nr in res])
            gap = np.abs(got["fraction"][:n_free_chk] - sure)
            check((gap <= near + 1e-6).all(), f"{name}: free fractions of 8192 probes x "
                  f"frames 0-{n_free_chk - 1} of {n_free} equal float64's but for probes within 2e-5 nm of a sphere "
                  f"({near.sum() * 8192:.0f}; mean fraction {got['mean_fraction']:.4f})")

        for (w, fit), got in sdfs.items():
            sure, near_w, near_n = fut[f"sdf {w} {fit}"].result()
            l1 = float(np.abs(got["counts"].reshape(-1) - sure).sum())
            check(l1 <= near_w + 1e-5 * sure.sum(),
                  f"sdf {w} fit={fit}: 40^3 voxel counts equal float64's (from the card's "
                  f"centre) but for {near_n} offsets within 2e-5 nm of a voxel face (L1 gap "
                  f"{l1:.3g}, their weight {near_w:.3g}); occupancy {got['occupancy']:.4f}")

        want = fut["polystat"].result()
        e = max(_rel(ps[k], want[k]) for k in ("ete2", "rg2"))
        e2 = float(np.abs(ps["bond_corr"] - want["bond_corr"]).max())
        check(e <= 1e-5 and e2 <= 1e-5 and ps["n_chains"] == mem_cols.shape[0],
              f"polystat: {ps['n_chains']} chains, ete2 and rg2 within relative 1e-5 of "
              f"float64 ({e:.2e}), bond correlation within 1e-5 ({e2:.2e})")

        want = fut["pairdist com"].result()
        sample, dists = want
        e = float(np.abs(pdc["dist"][:n_geo_chk, sample] - dists).max())
        check(pdc["dist"].shape == (n_geo, res_cols.shape[0], mem_cols.shape[0])
              and e <= GEO_TOL, f"pairdist com: {pdc['dist'].shape}, {len(sample)} residue "
              f"rows of frames 0-{n_geo_chk - 1} within {GEO_TOL:g} nm of float64 ({e:.2e})")
        e = max(float(np.abs(pdm["dist"][f] - m[:half // 10, half // 10:]).max())
                for f, m in enumerate(fut["pairdist min"].result()))
        check(e <= GEO_TOL, f"pairdist min: {pdm['dist'].shape}, frames 0-{n_geo_chk - 1} "
              f"within {GEO_TOL:g} nm of "
              f"float64 ({e:.2e})")

        near = [np.abs(d - 0.35) < 1e-5 for d in fut["select"].result()]
        hit = [d < 0.35 for d in fut["select"].result()]
        blocks = np.arange(nat - w0 - (nat - w0) % 3).reshape(-1, 3)
        bad = 0
        for f in range(n_geo_chk):
            sure = hit[f] & ~near[f]
            maybe = hit[f] | near[f]
            lo = np.zeros(nat - w0, bool)
            hi = np.zeros(nat - w0, bool)
            lo[blocks] = sure[blocks].any(1)[:, None]
            hi[blocks] = maybe[blocks].any(1)[:, None]
            tail = np.arange(blocks.size, nat - w0)     # the lone last OW
            lo[tail], hi[tail] = sure[tail], maybe[tail]
            got = sel["masks"][f]
            bad += int((lo & ~got).sum() + (got & ~hi).sum())
        check(bad == 0, f"select_dynamic within 0.35 nm whole_res: masks of frames "
              f"0-{n_geo_chk - 1} equal float64's but "
              f"for waters within 1e-5 nm of the cutoff ({int(sum(n.sum() for n in near))}); "
              f"sizes {sel['sizes']}")

        want = fut["trjorder"].result()
        for m, got in tro.items():
            e = float(np.abs(got["dist"][:n_geo_chk] - want[m]).max())
            check(e <= TRJ_TOL, f"trjorder {m}: {got['dist'].shape} distances, frames "
                  f"0-{n_geo_chk - 1} within "
                  f"{TRJ_TOL:g} nm of float64 ({e:.2e}); nshell {got['nshell']}")
            swaps = 0
            for f in range(n_geo_chk):
                differ = got["order"][f] != np.argsort(want[m][f], kind="stable")
                gap = np.abs(want[m][f][got["order"][f]]
                             - want[m][f][np.argsort(want[m][f], kind="stable")])
                swaps += int(differ.sum())
                check((gap[differ] <= 2 * TRJ_TOL).all(), f"trjorder {m} frame {f}: the order "
                      f"equals float64's but between molecules within {2 * TRJ_TOL:g} nm")
            say(f"  trjorder {m}: {swaps} ranks differ from float64's, all within the bound")

        for name, got, n_f, n_c, k in (("Peptide", pip, N_FRAMES, N_FRAMES, 400),
                                       ("Protein", pir, n_pi, n_pi_chk, n_prot)):
            want = np.asarray(fut[f"pi {name}"].result())
            e = float(np.abs(got["min_image"][:n_c] - want[:, 0]).max())
            e2 = float(np.abs(got["max_internal"][:n_c] - want[:, 1]).max())
            check(got["min_image"].shape == (n_f,) and e <= 1e-5 + 2e-5 * want.max()
                  and e2 <= 1e-5 + 2e-5 * want.max(),
                  f"pi_mindist {name} ({k} atoms, {n_f} frames): min image and max internal "
                  f"of frames 0-{n_c - 1} within rtol 2e-5 / atol 1e-5 of float64 ({e:.2e}, {e2:.2e}); min image "
                  f"{got['min_image'].min():.4f} nm")
    say(f"  oracles {time.perf_counter() - t_or:.1f} s on {ORACLE_THREADS} threads (each job's own "
        "seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in oracle_secs.items()) + ")")

    # ---- the small analyses, frame by frame ---------------------------------------
    ca = system.group_indices("CA")
    worst = {k: 0.0 for k in ("helix", "bundle", "dye", "gangle")}
    tcols = np.stack(np.split(ca, n_axes))
    bcols = np.stack(np.split(system.group_indices("PN"), n_axes))
    d_idx = [0, 4]
    a_idx = [n_prot // 2, n_prot // 2 + 4]
    gsites = {"vector": np.stack([ow[:n_whole], ow[:n_whole] + 1], 1),
              "plane": np.arange(w0, w0 + 3 * n_whole).reshape(-1, 3)}
    first = {g: testing.host_site_dirs(coords[0], c, boxes[0])[0] for g, c in gsites.items()}
    g_over, undecided, helix_far = 0.0, 0, 0.0
    for f in range(N_FRAMES):
        p, bx = coords[f], boxes[f]
        h = testing.host_helixorient(p[ca], bx, 2, like=hx["local_axes"][f])
        undecided += h["undecided"]
        over = [np.abs(hx["rise_per_residue"][f] - h["rise_per_residue"])
                / (h["bound_rise"] + 1e-5),
                np.abs(np.cos(np.radians(hx["twist_per_residue"][f]))
                       - np.cos(np.radians(h["twist_per_residue"]))) / (h["bound_cos"] + 1e-6),
                np.abs(hx["axis_vec"][f] - h["axis_vec"]) / (h["bound_axis"] + 1e-5),
                abs(np.cos(np.radians(hx["tilt"][f])) - np.cos(np.radians(h["tilt"])))
                / (h["bound_axis"] + 1e-5),
                abs(hx["rise"][f] - h["rise"]) / (h["bound_rise"].mean() + 1e-5),
                abs(hx["twist"][f] - h["twist"]) / (h["bound_twist_mean"] + 1e-4),
                abs(hx["radius"][f] - h["radius"]) / (h["bound_radius_mean"] + 1e-5)]
        worst["helix"] = max(worst["helix"], *(float(np.max(o)) for o in over))
        helix_far = max(helix_far, float(np.abs(hx["rise_per_residue"][f]
                                                - h["rise_per_residue"]).max()))
        b = testing.host_bundle(p, tcols, mass[tcols] / mass[tcols].sum(1, keepdims=True),
                                bcols, mass[bcols] / mass[bcols].sum(1, keepdims=True), bx, 2)
        worst["bundle"] = max(worst["bundle"], *(float(np.abs(bu[k][f] - b[k]).max())
                                                 for k in ("length", "distance", "zshift",
                                                           "axes", "center")),
                              *(float(np.abs(np.cos(np.radians(bu[k][f]))
                                             - np.cos(np.radians(b[k]))).max())
                                for k in ("tilt",)),
                              *(float(np.abs(np.sin(np.radians(bu[k][f]))
                                             - np.sin(np.radians(b[k]))).max())
                                for k in ("tiltr", "tiltl")))
        r, k2 = testing.host_dyecoupl(p, d_idx, a_idx, bx)
        worst["dye"] = max(worst["dye"], abs(dy["r"][f] - r), abs(dy["kappa2"][f] - k2))
        for (g1, g2), got in ga.items():
            dirs, bound = testing.host_site_dirs(p, gsites[g1], bx)
            ref = dirs[:, 2] if g2 == "z" else (dirs * first[g1]).sum(-1)
            gap = np.abs(np.cos(np.radians(got["angles"][f])) - ref)
            g_over = max(g_over, float((gap / (2 * bound + 1e-6)).max()))
            worst["gangle"] = max(worst["gangle"], float(gap.max()))
    check(worst["helix"] <= 1.0, f"helixorient over {len(ca)} C-alphas x {N_FRAMES} "
          f"frames: every window's rise and twist cosine, the means and the axis within "
          f"float64 plus what the float32 rebuild of the chain moves them by "
          f"(testing.host_helixorient's bounds; largest {worst['helix']:.3f} of its bound, "
          f"largest rise gap {helix_far:.2e} nm; {undecided} local axes within 1e-4 of the "
          "sign rule's edge take the card's sign; random C-alphas, so near-parallel "
          "bisectors are common)")
    check(worst["bundle"] <= GEO_TOL, f"bundle of {n_axes} segments: lengths, distances, shifts, "
          f"axes and the centre within {GEO_TOL:g} nm, the tilts' cosines and sines within "
          f"{GEO_TOL:g} of float64 ({worst['bundle']:.2e})")
    check(worst["dye"] <= 1e-5, f"dyecoupl: R and kappa^2 within 1e-5 of float64 "
          f"({worst['dye']:.2e})")
    check(g_over <= 1.0, f"gangle vectors and planes of {n_whole} waters against z and t0: "
          f"cosines within twice the float32 reach of each site's direction (largest gap "
          f"{worst['gangle']:.2e}, {g_over:.3f} of its bound)")

    # saltbr: the charged units and their distances
    res_names = testing.named_layout(nat)["resname"][:salt_atoms:testing.RESIDUE_SIZE]
    charged = np.flatnonzero(np.isin(res_names, ("LYS", "ARG", "ASP", "GLU")))
    want_labels = [f"{res_names[u]}-{u + 1}" for u in charged]
    ok = list(sb["labels"]) == want_labels and np.array_equal(
        sb["charges"], np.where(np.isin(res_names[charged], ("LYS", "ARG")), 1.0, -1.0))
    e = 0.0
    iu, ju = sb["pairs"][:, 0], sb["pairs"][:, 1]
    for f in range(N_FRAMES):
        c = testing.host_unit_means(coords[f], res_cols[charged], res_w[charged], boxes[f])
        d = testing._mi(c[iu] - c[ju], boxes[f])
        e = max(e, float(np.abs(sb["dist"][f] - np.sqrt((d * d).sum(-1))).max()))
    check(ok and e <= GEO_TOL, f"saltbr over {salt_atoms // 10} residues: the "
          f"{len(charged)} LYS/ARG/ASP/GLU units with charges +1/-1, {len(iu)} pairs within "
          f"{GEO_TOL:g} nm of float64 ({e:.2e}; kinds "
          f"{dict(zip(*np.unique(sb['kinds'], return_counts=True)))})")

    # the cylinder selection
    lo_hi = [testing.host_in_shape(coords[f, w0:], boxes[f], cyl) for f in range(N_FRAMES)]
    check(all(lo <= s <= hi for (lo, hi), s in zip(lo_hi, sc["sizes"])),
          f"select_dynamic cylinder over {N_FRAMES} frames: sizes within the float64 count "
          f"bounds (sizes {sc['sizes'].min()}-{sc['sizes'].max()})")

    # trjorder output= read back: the solvent permuted into the sorted order
    q_back = native.xtc_read_frames(out_xtc, native.xtc_scan(out_xtc)[0], nat)[0]
    sol = np.arange(w0, w0 + 3 * n_whole).reshape(-1, 3)
    half_q = 0.5 / float(system.get_precision())
    e = max(float(np.abs(q_back[f][sol.reshape(-1)] - coords[f][sol[trw["order"][f]].reshape(-1)]
                         ).max()) for f in range(n_geo))
    check(np.array_equal(trw["order"], tro["atom"]["order"]) and e <= half_q + 4e-6,
          f"trjorder output=: {n_geo} frames read back, the waters in sorted order within "
          f"half of 1/precision and two ulps ({e:.2e})")
    os.unlink(out_xtc)

    # helixorient on an ideal alpha-helix
    h_ideal, cb = _ideal_helix_call(dev, testing.ideal_backbone(60, *testing.HELIX_PHI_PSI)[1])
    want = testing.host_helixorient(cb, np.full(3, 20.0), 2)
    check(abs(h_ideal["rise"][0] - want["rise"]) <= 1e-5
          and abs(h_ideal["twist"][0] - want["twist"]) <= 1e-3
          and abs(want["rise"] - 0.15) < 0.01 and abs(want["twist"] - 100.0) < 2.0,
          f"helixorient of an ideal 60-residue alpha-helix: rise {h_ideal['rise'][0]:.5f} nm, "
          f"twist {h_ideal['twist'][0]:.3f} deg, radius {h_ideal['radius'][0]:.4f} nm, equal "
          f"to float64 within 1e-5 nm / 1e-3 deg")

    # ---- resident windows, determinism ---------------------------------------
    t0 = time.perf_counter()
    dt = M.TrajectoryAnalysis(system, device=dev).runner(ship="all").load_device(
        xtc, batch_size=BATCH)
    for label, again, want in (
            ("sdf mass fit", M.sdf(system, dt, "OW", "Protein", side=4.0, bins=40, fit=True,
                                   weights="mass"), sdfs[("mass", True)]),
            ("pi_mindist Peptide", M.pi_mindist(system, dt, "Peptide"), pip),
            ("select cylinder", M.select_dynamic(system, dt, "Water", shape=cyl), sc),
            ("gangle plane t0", M.gangle(system, dt, "WW", g1="plane", g2="t0"),
             ga[("plane", "t0")])):
        check(all(np.array_equal(want[k], again[k], equal_nan=True) for k in want
                  if not isinstance(want[k], (int, float, str))),
              f"{label} over load_device(ship='all'): the file call's bits")
    del dt
    again = M.sdf(system, xtc, "OW", "Protein", side=4.0, bins=40, fit=True, weights="mass",
                  batch_size=BATCH)
    check(np.array_equal(again["counts"], sdfs[("mass", True)]["counts"]),
          "sdf mass fit twice: the same bits")
    say(f"  windows and repeats: {time.perf_counter() - t0:.1f} s")
    for path in (gxtc, fxtc, one):
        os.unlink(path)

    # ---- the triclinic forms, chi on the card, the triclinic dihedral margin --------
    _geometry_triclinic(torch, dev)
    _chi_on_card(dev)
    if tri_site is not None:
        say(f"  the triclinic dihedral margin (phase 9): worst site frame {tri_site['frame']}, "
            f"site {tri_site['site']} (atoms {tri_site['atoms']}), error "
            f"{tri_site['error']:.3e} deg, central bond {tri_site['central_bond']:.4f} nm, "
            f"bends {tri_site['bends'][0]:.3f} / {tri_site['bends'][1]:.3f} deg, lever arm "
            f"{tri_site['lever']:.4f} nm, crosses the box: {tri_site['crosses_box']}; one "
            f"float32 ulp over the lever arm = {tri_site['f32_scale']:.3e} deg")
    say(f"  phase 16 seconds: {time.perf_counter() - t_phase:.1f}")
    return counts


def _ideal_helix_call(dev, ca):
    """`helixorient` of C-alphas `ca` [R, 3] written as a one-frame XTC ->
    (its result, the decoded C-alphas)."""
    from groan_rs_tpu_torch import convert
    from groan_rs_tpu_torch import models as M
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.ops import kernels as K

    n = ca.shape[0]
    pos = (ca - ca.mean(0) + 10.0).astype(np.float32)
    path = os.path.join(K.BUILD_DIR, "smoke_helix.xtc")
    if os.path.exists(path):
        os.unlink(path)
    native.xtc_write_frame(path, n, 0, 0.0, np.diag(np.full(3, 20.0, np.float32)).reshape(9),
                           pos, 100000.0)
    system = convert.system_from_state({
        "positions": pos, "box": np.full(3, 20.0, np.float32),
        "mass": np.ones(n, np.float32), "has_mass": np.ones(n, bool), "precision": 100000,
        "atomname": np.full(n, "CA"), "resname": np.full(n, "ALA"),
        "resnum": np.arange(1, n + 1), "groups": {"H": np.arange(n)}}, device=dev)
    out = M.helixorient(system, path, "H")
    decoded = native.xtc_read_frames(path, native.xtc_scan(path)[0], n)[0][0]
    os.unlink(path)
    return out, decoded


def _geometry_triclinic(torch, dev):
    """`sasa`, `freevolume`, `select_dynamic` and `pi_mindist` on phase 8's
    rhombic dodecahedron against the triclinic float64 oracles; no kernel
    launches."""
    from groan_rs_tpu_torch import testing
    from groan_rs_tpu_torch import models as M
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.ops import kernels as K
    from groan_rs_tpu_torch.utils import threefry

    xtc = triclinic_xtc(BATCH)
    offs, _, _, nat = native.xtc_scan(xtc)
    coords, b9s = native.xtc_read_frames(xtc, offs, nat)[:2]
    boxes = b9s.reshape(-1, 3, 3).astype(np.float64)
    n_t = min(TRI_FRAMES, BATCH)
    short = _frame_copy(xtc, offs, n_t, "tri")
    system = _geometry_system(coords[0], boxes[0].astype(np.float32), dev)
    n_prot = testing.synthetic_layout(nat)["n_prot"]
    w0 = testing.synthetic_layout(nat)["w0"]
    vdw = system.topology.vdw.astype(np.float64)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    sa = M.sasa(system, short, "Peptide", max_neighbors=SASA_CAP, batch_size=BATCH)
    fv = M.freevolume(system, short, "Protein", n_samples=8192, seed=0, batch_size=BATCH)
    sel = M.select_dynamic(system, short, "Water", within=0.35, of="Peptide", batch_size=BATCH)
    pi = M.pi_mindist(system, xtc, "Peptide", batch_size=BATCH)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    say(f"  triclinic sasa, freevolume, select ({n_t} frames), pi_mindist ({BATCH} frames): "
        f"{time.perf_counter() - t0:.2f} s")
    no_launches(dict(K.launch_counts), "the triclinic geometric analyses")
    worst = 0.0
    for f in range(n_t):
        area, _, slack = testing.host_sasa(coords[f, :400], boxes[f], vdw[:400] + 0.14,
                                           np.arange(400))
        worst = max(worst, float((np.abs(sa["area"][f] - area)
                                  / (slack + 2e-6 * area + 1e-6)).max()))
    check(worst <= 1.0, f"triclinic sasa of the Peptide within float64 but for test points "
          f"at a sphere ({worst:.3f} of the bound)")
    u = threefry.uniform(0, (n_t, 8192, 3))
    gap = 0.0
    for f in range(n_t):
        h = boxes[f].astype(np.float32)
        xyz = u[f][:, 0:1] * h[0] + u[f][:, 1:2] * h[1] + u[f][:, 2:3] * h[2]
        free, near = testing.host_free_points(xyz, coords[f, :n_prot], boxes[f], vdw[:n_prot])
        gap = max(gap, abs(fv["fraction"][f] - free.mean()) - near.mean())
    check(gap <= 1e-6, f"triclinic freevolume of the Protein: fractions equal float64's but "
          f"for probes at a sphere ({fv['fraction']})")
    bad = 0
    for f in range(n_t):
        d = testing.host_nearest(coords[f, w0:], coords[f, :400], boxes[f])
        near = np.abs(d - 0.35) < 1e-5
        bad += int(((sel["masks"][f] != (d < 0.35)) & ~near).sum())
    check(bad == 0, f"triclinic select_dynamic within 0.35 nm of the Peptide: masks equal "
          f"float64's but within 1e-5 nm of the cutoff (sizes {sel['sizes']})")
    e = 0.0
    for f in range(BATCH):
        mn, mx = testing.host_self_image(coords[f, :400], boxes[f])
        e = max(e, abs(pi["min_image"][f] - mn) / (1e-5 + 2e-5 * mx),
                abs(pi["max_internal"][f] - mx) / (1e-5 + 2e-5 * mx))
    check(e <= 1.0, f"triclinic pi_mindist of the Peptide over {BATCH} frames within rtol "
          f"2e-5 / atol 1e-5 of float64 ({e:.3f} of the bound)")
    os.unlink(short)


SAXS_FRAMES = 1         # frames of saxs of the Protein: O(K^2 Q) Debye terms a frame (2 before phase 22)
SAXS_ORACLE_FRAMES = 1  # of them, the frames the float64 Debye sum checks
SAXS_ORACLE_STEP = 10   # every 10th q of the float64 Debye sum on the card
SINC_FMA_OPS = 37       # FP32 instructions of a Debye term (see late_models_phase)
WHAM_WINDOWS, WHAM_SAMPLES, WHAM_BINS = 40, 100_000, 200
BAR_INTERVALS, BAR_SAMPLES = 20, 50_000
LIE_FRAMES = 10_000
INSERT_COPIES, INSERT_ATOMS = 50, 20
IONS = 150              # NA and CL each
GENCONF_NBOX = (2, 2, 1)


def _chain_molecule(n, seed, dev):
    """A seeded 20-atom chain molecule (0.15 nm bonds, bends of at least
    90 degrees), one residue LIG -> its System on `dev`."""
    from groan_rs_tpu_torch import convert

    rng = np.random.default_rng(seed)
    pos = [np.zeros(3)]
    step = np.array([0.15, 0.0, 0.0])
    for _ in range(n - 1):
        while True:
            d = rng.normal(size=3)
            d *= 0.15 / np.linalg.norm(d)
            if d @ step >= 0.0:
                break
        step = d
        pos.append(pos[-1] + d)
    return convert.system_from_state({
        "positions": np.asarray(pos, np.float32), "box": np.full(3, 5.0, np.float32),
        "mass": np.full(n, 12.011, np.float32), "has_mass": np.ones(n, bool),
        "charge": np.zeros(n, np.float32), "has_charge": np.ones(n, bool),
        "atomname": np.array([f"C{i + 1}" for i in range(n)]), "element": np.full(n, "C"),
        "resname": np.full(n, "LIG"), "resnum": np.ones(n, np.int64),
        "bonds": np.stack([np.arange(n - 1), np.arange(1, n)], 1), "groups": {}}, device=dev)


def _void(a):
    """Rows of a float32 [N, 3] array as hashable byte strings."""
    a = np.ascontiguousarray(a, np.float32)
    return a.view(np.dtype((np.void, 12))).ravel()


def _saxs_checks(got, pos, ff, q, what, host=False):
    """`got["per_frame"]` against the float64 Debye sum: on the card at
    every SAXS_ORACLE_STEP-th q (`testing.debye_f64`), or on the host at all
    q (`testing.host_debye`).  Float32 sums of K^2 terms lose about u
    sqrt(K) of their absolute sum, and at high q the curve is small beside
    it (the terms cancel), so the error is held to 1e-5 of the float64 sum
    of |terms| and printed beside the relative error."""
    from groan_rs_tpu_torch import testing

    cols = np.arange(len(q)) if host else np.arange(0, len(q), SAXS_ORACLE_STEP)
    if host:
        want, absum = testing.host_debye(pos.double().cpu().numpy(), ff, q)
    else:
        want, absum = testing.debye_f64(pos, ff[:, cols], q[cols])
    err = np.abs(got["per_frame"][:, cols] - want)
    rel = (err / np.abs(want)).max()
    check(bool(np.isfinite(got["per_frame"]).all()) and (err <= 1e-5 * absum).all(),
          f"{what} against the float64 Debye sum ({'host' if host else 'card'}, "
          f"{len(cols)} q x {want.shape[0]} frames): largest error {(err / absum).max():.2e} "
          f"of the sum of |terms| (1e-5), relative {rel:.2e}")


def late_models_phase(torch, xtc, offs, nat, frame0, box, dev):
    """Phase 17: the scattering, free-energy and system-preparation families
    (`models/scattering.py`, `freeenergy.py`, `prep.py`) at 1M atoms -> the
    K1/K2/K3 launches of its main path (predicted 0, 0, 0: no function of
    the three families reaches a kernel)."""
    from concurrent.futures import ThreadPoolExecutor

    from groan_rs_tpu_torch import convert, testing
    from groan_rs_tpu_torch import models as M
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.models import pipeline as P
    from groan_rs_tpu_torch.ops import kernels as K
    from groan_rs_tpu_torch.system import System

    say(f"phase 17: scattering, free energy and system preparation, {nat} atoms")
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    lay = testing.synthetic_layout(nat)
    n_prot, n_mem, w0 = lay["n_prot"], lay["n_mem"], lay["w0"]
    system = _geometry_system(frame0, box, dev)
    n_sx = min(SAXS_FRAMES, N_FRAMES)
    sxtc = _frame_copy(xtc, offs, n_sx, "saxs")
    one = _frame_copy(xtc, offs, 1, "sans")
    box32 = np.asarray(box, np.float32)
    base = System("Protein+Membrane", system.topology.subset(np.arange(w0)),
                  simbox=system.simbox, positions=system.positions[:w0], device=dev)
    membrane = System("Membrane", system.topology.subset(np.arange(n_prot, w0)),
                      simbox=system.simbox, positions=system.positions[n_prot:w0], device=dev)
    mol = _chain_molecule(INSERT_ATOMS, 0, dev)
    tile = convert.system_from_state(testing.water_tile(0), device=dev)
    kt = testing.BOLTZ * 300.0
    centers = np.linspace(-1.5, 1.5, WHAM_WINDOWS)
    windows = testing.harmonic_windows(17, 4.0, 300.0, centers, WHAM_SAMPLES, kt)
    d_f = np.random.default_rng(18).uniform(-4.0, 4.0, BAR_INTERVALS)
    intervals = [testing.crooks_gaussian(100 + i, float(d_f[i]), 2.0, BAR_SAMPLES, kt)
                 for i in range(BAR_INTERVALS)]
    e_rng = np.random.default_rng(19)
    e_lj, e_qq = e_rng.normal(-45.0, 6.0, LIE_FRAMES), e_rng.normal(-120.0, 15.0, LIE_FRAMES)
    secs = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        return out

    # ---- the phase's main path: what a user calls, from the file names -----
    K.reset_launch_counts()
    t_main = time.perf_counter()
    sx = timed(f"saxs Protein ({n_sx} frames)", lambda: M.saxs(system, sxtc, "Protein"))
    sn = timed("sans Protein deuterated (1 frame)", lambda: M.sans(
        system, one, "Protein", deuterate=True))
    sp = timed(f"saxs Peptide ({n_sx} frames)", lambda: M.saxs(system, sxtc, "Peptide"))
    di = timed("dielectric Water", lambda: M.dielectric(system, xtc, "Water",
                                                         batch_size=BATCH))
    ds = timed("dielectric_spectrum Water", lambda: M.dielectric_spectrum(
        system, xtc, "Water", batch_size=BATCH))
    wh = timed(f"wham {WHAM_WINDOWS} x {WHAM_SAMPLES}", lambda: M.wham(windows,
                                                                     bins=WHAM_BINS))
    br = timed(f"bar_intervals {BAR_INTERVALS} x {BAR_SAMPLES}",
               lambda: M.bar_intervals(intervals))
    li = timed(f"lie {LIE_FRAMES} frames", lambda: M.lie(e_lj, e_qq))
    ins, n_ins = timed(f"insert_molecules {INSERT_COPIES} x {INSERT_ATOMS}", lambda:
                       M.insert_molecules(base, mol, INSERT_COPIES, radius=0.21, seed=0))
    solv, n_sol = timed("solvate", lambda: M.solvate(ins, tile))
    ion, ion_idx = timed(f"genion {IONS} NA + {IONS} CL", lambda: M.genion(
        solv, IONS, IONS, seed=0))
    gc = timed(f"genconf Membrane {GENCONF_NBOX}", lambda: M.genconf(membrane, GENCONF_NBOX))
    t_main = time.perf_counter() - t_main
    counts = dict(K.launch_counts)
    say("  seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    say(f"  the phase's main path: {t_main:.2f} s")
    if cuda:
        say(f"  max_memory_allocated over the main path: "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    predicted = {"bai_breen_estimate": 0, "bai_breen_refine": 0, "pair_reduce": 0}
    say(f"  launches: K1 {counts['bai_breen_estimate']}, K2 {counts['bai_breen_refine']}, "
        f"K3 {counts['pair_reduce']} (predicted {predicted})")
    no_launches(counts, "phase 17's main path")
    for s, what in ((ins, "insert_molecules"), (solv, "solvate"), (ion, "genion"),
                    (gc, "genconf")):
        check(s.device == system.device, f"{what}'s System computes on {s.device}")

    # the Debye sums' share of their FP32 bound: pairs x q x (a sinc, its
    # arguments and an FMA) over 3.35e13/s.  A term is 37 FP32 instructions:
    # q d and the product by 1/pi (2), sinc = sin(pi x) / (pi x) with its
    # zero test (pi x 1, sinf's Cody-Waite reduction and polynomial ~22, a
    # division ~9, the test and select 2) and the matrix-vector FMA (1)
    n_q = len(sx["q"])
    for name, k, frames in ((f"saxs Protein ({n_sx} frames)", n_prot, n_sx),
                            ("sans Protein deuterated (1 frame)", n_prot, 1)):
        bound = float(k) * k * n_q * SINC_FMA_OPS / 3.35e13
        say(f"  {name}: {float(k) * k * n_q:.3e} terms a frame, {SINC_FMA_OPS} FP32 "
            f"instructions a term, bound {1e3 * bound:.1f} ms a frame, measured "
            f"{secs[name] / frames:.3f} s a frame = {100 * bound * frames / secs[name]:.2f}% "
            f"of bound, {100 * secs[name] / t_main:.1f}% of the main path")
    n_cand = int(np.prod(np.maximum(np.ceil(box32 / testing.water_tile(0)["box"]), 1))) \
        * tile.get_n_atoms() // 3
    say(f"  solvate: {n_cand} candidate molecules, {n_sol} kept; insert_molecules "
        f"{n_ins} copies")

    # ---- against float64 oracles --------------------------------------------
    t_or = time.perf_counter()
    oracle_secs, marks = {}, [t_or]

    def lap(name):
        marks.append(time.perf_counter())
        oracle_secs[name] = marks[-1] - marks[-2]

    q = sx["q"]
    coords, b9s = native.xtc_read_frames(xtc, offs[:N_FRAMES], nat)[:2]
    boxes = b9s[:, [0, 4, 8]].astype(np.float64)
    lap("reading the XTC")
    from groan_rs_tpu_torch.models import scattering as S

    elements = [system.topology.element_symbol[i] for i in range(n_prot)]
    n_sx_chk = min(SAXS_ORACLE_FRAMES, n_sx)
    pos_p = torch.from_numpy(coords[:n_sx_chk, :n_prot]).to(dev)
    _saxs_checks({"per_frame": sx["per_frame"][:n_sx_chk]}, pos_p,
                 S._cm_form_factors(elements, q), q, f"saxs Protein (frames 0-{n_sx_chk - 1} "
                 f"of {n_sx})")
    b = np.array([P._NEUTRON_B["D" if e.upper() == "H" else e.upper()] for e in elements])
    _saxs_checks(sn, pos_p[:1], np.repeat(b[:, None], len(q), 1), q,
                 "sans Protein deuterated")
    del pos_p
    pep = system.group_indices("Peptide")
    pel = [system.topology.element_symbol[int(i)] for i in pep]
    _saxs_checks(sp, torch.from_numpy(coords[:n_sx, pep]), S._cm_form_factors(pel, q),
                 q, f"saxs Peptide ({len(pep)} atoms)", host=True)
    check(sn["i0"] == float(b.sum() ** 2) and sx["per_frame"].shape == (n_sx, n_q),
          f"saxs / sans shapes and i0 ({sx['per_frame'].shape}, i0 {sn['i0']:.6g})")

    lap("Debye sums")
    # dielectric: M per frame by per-molecule minimum image in float64, the
    # molecules the layout's water triplets (and the lone last oxygen)
    widx = system.group_indices("Water")
    wmol = (widx - w0) // 3
    wq = system.topology.charge[widx].astype(np.float64)
    with ThreadPoolExecutor(ORACLE_THREADS) as ex:
        m_ref = np.array(list(ex.map(lambda f: testing.host_total_dipole(
            coords[f][widx], boxes[f], wq, wmol), range(N_FRAMES))))
    scale = np.abs(m_ref).max()
    m_err = float(np.abs(di["M"] - m_ref).max())
    check(m_err <= 1e-4 * scale, f"dielectric M of {len(widx)} atoms against float64 over "
          f"{N_FRAMES} frames: {m_err:.3e} (1e-4 of the largest |M|, {scale:.4f} e nm)")
    qm = np.bincount(wmol, weights=wq)
    n_charged = int((np.abs(qm) > 1e-3).sum())
    check(di["n_charged_molecules"] == n_charged == 1,
          f"n_charged_molecules {di['n_charged_molecules']} (float64 count {n_charged}: "
          "the lone last oxygen)")
    vol = float(np.prod(boxes, axis=1).mean())
    t = ds["lag_times"]
    ref = testing.host_dielectric(m_ref, vol, 300.0, t, ds["omega"])
    bnd = testing.dielectric_bound(m_ref, m_err, vol, 300.0, ref["epsilon"], ds["omega"],
                                   ref["fl"], float(t[-1] - t[0]))
    e_eps = abs(di["epsilon"] - ref["epsilon"])
    check(e_eps <= bnd["eps"] and abs(ds["eps_static"] - di["epsilon"]) <= bnd["eps"],
          f"epsilon {di['epsilon']:.6f} against float64 {ref['epsilon']:.6f}: {e_eps:.3e} "
          f"within the bound from M's error {bnd['eps']:.3e}")
    e_phi = float(np.abs(ds["phi"] - ref["phi"]).max())
    e_spec = np.abs((ds["eps_real"] - ref["eps_real"]) + 1j * (ds["eps_imag"] - ref["eps_imag"]))
    check(e_phi <= bnd["phi"] and (e_spec <= bnd["spectrum"]).all(),
          f"dielectric_spectrum: phi within {e_phi:.3e} (bound {bnd['phi']:.3e}), eps' and "
          f"eps'' within {e_spec.max():.3e} (largest share of the bound "
          f"{(e_spec / bnd['spectrum']).max():.3f}) over {len(ds['omega'])} frequencies")

    lap("dielectric")
    # wham, bar, lie against their closed forms
    dx = wh["x"][1] - wh["x"][0]
    edges = np.concatenate([wh["x"] - dx / 2, wh["x"][-1:] + dx / 2])
    exact = testing.wham_exact(edges, 4.0, 300.0, centers, kt)
    inner = np.abs(wh["x"]) < 1.4
    gap = wh["pmf"][inner] - exact["pmf"][inner]
    e_pmf = float(np.abs(gap - gap.mean()).max())
    e_f = float(np.abs(wh["f"] - exact["f"]).max())
    check(wh["converged"] and e_pmf <= 0.1 * kt and e_f <= 0.1 * kt,
          f"wham ({WHAM_WINDOWS} x {WHAM_SAMPLES}, {WHAM_BINS} bins, {wh['n_iter']} "
          f"iterations): PMF within {e_pmf / kt:.4f} kT and window free energies within "
          f"{e_f / kt:.4f} kT of the closed form (0.1 kT)")
    z = np.abs(br["delta_f"] - d_f) / br["error"]
    zt = abs(br["total"] - d_f.sum()) / br["total_error"]
    check(z.max() <= 5.0 and zt <= 5.0,
          f"bar_intervals: each interval within {z.max():.2f} of its error of the drawn "
          f"free energy, the total {br['total']:.4f} within {zt:.2f} errors of "
          f"{d_f.sum():.4f} (5)")
    dg = 0.181 * e_lj + 0.5 * e_qq
    check(abs(li["dg_mean"] - dg.mean()) <= 1e-9 * abs(dg.mean())
          and abs(li["dg_std"] - dg.std(ddof=1) / np.sqrt(LIE_FRAMES)) <= 1e-9 * li["dg_std"],
          f"lie: dG {li['dg_mean']:.6f} +- {li['dg_std']:.6f} equals its closed form")

    lap("wham, bar, lie")
    # insert_molecules: every inserted atom at least the radius from all
    # before it (float32 reach 1e-5 nm excused), the count, the same bits
    # again
    ipos = np.asarray(ins.positions, np.float64)
    check(n_ins == INSERT_COPIES and ins.get_n_atoms() == w0 + INSERT_COPIES * INSERT_ATOMS,
          f"insert_molecules: {n_ins} copies, {ins.get_n_atoms()} atoms")
    copies = ipos[w0:].reshape(INSERT_COPIES, INSERT_ATOMS, 3)
    least = float(testing.host_nearest(copies.reshape(-1, 3), ipos[:w0], box).min())
    for j in range(1, INSERT_COPIES):
        d = testing._mi(copies[j][:, None, :] - copies[:j].reshape(1, -1, 3), box)
        least = min(least, float(np.sqrt((d * d).sum(-1)).min()))
    check(least >= 0.21 - 1e-5, f"insert_molecules: the least distance of an inserted atom "
          f"to anything before it {least:.5f} nm (radius 0.21)")
    again, _ = M.insert_molecules(base, mol, INSERT_COPIES, radius=0.21, seed=0)
    check(np.asarray(again.positions).tobytes() == np.asarray(ins.positions).tobytes(),
          "insert_molecules again with seed 0: the same bits")
    del again

    lap("insert_molecules (and again)")
    # solvate: the candidates rebuilt on the host, kept by a periodic tree
    tst = testing.water_tile(0)
    sbox = tst["box"].astype(np.float64)
    reps = np.maximum(np.ceil(box32 / tst["box"]), 1).astype(int)
    tpos = tst["positions"].astype(np.float64).reshape(-1, 3, 3)
    cands = np.concatenate([tpos + np.array([ix, iy, iz], np.float64) * sbox
                            for ix in range(reps[0]) for iy in range(reps[1])
                            for iz in range(reps[2])])
    cands = cands[(cands[:, 0] < box32).all(axis=1)]
    keep, near = testing.host_clash_keep(cands.reshape(-1, 3), np.arange(len(cands)) * 3,
                                         ipos, box, 0.24)
    got_first = _void(np.asarray(solv.positions)[ins.get_n_atoms()::3])
    cand_first = _void(cands[:, 0].astype(np.float32))
    kept = np.isin(cand_first, got_first)
    check(len(got_first) == n_sol and kept.sum() == n_sol
          and not (kept != keep)[~near].any(),
          f"solvate: {n_sol} of {len(cands)} candidate molecules kept, the periodic tree's set "
          f"but for {int(near.sum())} within 1e-5 nm of the radius "
          f"({int((kept != keep).sum())} differ)")
    check(np.asarray(solv.positions)[ins.get_n_atoms():].tobytes()
          == cands[kept].reshape(-1, 3).astype(np.float32).tobytes(),
          "solvate: the kept waters at their tiles' positions, in the tiles' order")

    lap("solvate")
    # genion: ions on replaced waters' first atoms, the books balance
    spos = np.asarray(solv.positions, np.float32)
    ipos2 = np.asarray(ion.positions, np.float32)
    sol_first = _void(spos[ins.get_n_atoms()::3])
    n_ion = 2 * IONS
    names = [ion.topology.atomname[int(i)] for i in ion_idx]
    q_ion = ion.topology.charge[ion_idx].astype(np.float64)
    q_drop = solv.topology.charge.astype(np.float64).sum() - (
        ion.topology.charge.astype(np.float64).sum() - q_ion.sum())
    check(np.array_equal(ion_idx, np.arange(ion.get_n_atoms() - n_ion, ion.get_n_atoms()))
          and ion.get_n_atoms() == solv.get_n_atoms() - 3 * n_ion + n_ion
          and np.isin(_void(ipos2[ion_idx]), sol_first).all()
          and not np.isin(_void(ipos2[ins.get_n_atoms():ion_idx[0]:3]),
                          _void(ipos2[ion_idx])).any()
          and names == ["NA"] * IONS + ["CL"] * IONS
          and q_ion.sum() == 0.0 and abs(q_drop) < 1e-2,
          f"genion: {n_ion} ions on replaced waters' oxygens, {ion.get_n_atoms()} atoms, ion "
          f"charge {q_ion.sum():+.1f}, replaced waters' charge {q_drop:+.2e}")
    again, again_idx = M.genion(solv, IONS, IONS, seed=0)
    check(np.asarray(again.positions).tobytes() == ipos2.tobytes()
          and np.array_equal(again_idx, ion_idx), "genion again with seed 0: the same bits")
    del again

    lap("genion (and again)")
    # genconf: copies shifted exactly, residues renumbered, the box scaled
    mp = np.asarray(membrane.positions, np.float64)
    gp = np.asarray(gc.positions, np.float32)
    res0 = np.asarray(membrane.topology.resnum)
    uniq, inv = np.unique(res0, return_inverse=True)
    ok = True
    for k, (ix, iy, iz) in enumerate((a, b_, c) for a in range(GENCONF_NBOX[0])
                                     for b_ in range(GENCONF_NBOX[1])
                                     for c in range(GENCONF_NBOX[2])):
        sl = slice(k * n_mem, (k + 1) * n_mem)
        want = (mp + np.array([ix, iy, iz], np.float64) * box32.astype(np.float64)).astype(
            np.float32)
        want_res = res0 if k == 0 else res0.max() + 1 + (k - 1) * len(uniq) + inv
        ok &= gp[sl].tobytes() == want.tobytes() and np.array_equal(
            np.asarray(gc.topology.resnum)[sl], want_res)
    gbox = np.array([gc.simbox.x, gc.simbox.y, gc.simbox.z])
    check(ok and gc.get_n_atoms() == 4 * n_mem
          and np.allclose(gbox, box32 * np.array(GENCONF_NBOX), rtol=0, atol=1e-6),
          f"genconf {GENCONF_NBOX}: {gc.get_n_atoms()} atoms shifted exactly, residues "
          f"renumbered, box {gbox}")
    lap("genconf")
    say(f"  oracles: {time.perf_counter() - t_or:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in oracle_secs.items()) + ")")
    for path in (sxtc, one):
        os.unlink(path)
    say(f"  phase 17 seconds: {time.perf_counter() - t_phase:.1f}")
    return counts


READER_FRAMES = 24      # frames of the TNG, DCD and NetCDF files (phase 4's first 24)
GZIP_TNG_FRAMES = 12    # of which the gzip TNG (its host write took ~0.85 s a frame; one
                        # whole batch: its pass is held to the XTC pass bit for bit)
TEXT_FRAMES = 1         # frames of the LAMMPS, XYZ and MOL2 files (1M lines a frame; 2 before phase 22)
VEC_N = 1_000_000       # vectors of the vecmath checks


def _vecmath_checks(torch, dev):
    """Each function of `ops/vecmath.py` on VEC_N float32 vectors on the
    card against float64 numpy; device ms per call (CUDA events)."""
    from groan_rs_tpu_torch.ops import vecmath as V

    rng = np.random.default_rng(18)
    a64, b64 = rng.normal(size=(2, VEC_N, 3)) * 3.0
    d64 = rng.uniform(-2.0, 2.0, VEC_N)
    th64 = rng.uniform(-np.pi, np.pi, VEC_N)
    a32, b32 = a64.astype(np.float32), b64.astype(np.float32)
    a64, b64 = a32.astype(np.float64), b32.astype(np.float64)
    d64 = d64.astype(np.float32).astype(np.float64)
    th64 = th64.astype(np.float32).astype(np.float64)
    a, b = torch.from_numpy(a32).to(dev), torch.from_numpy(b32).to(dev)
    d = torch.from_numpy(d64.astype(np.float32)).to(dev)
    th = torch.from_numpy(th64.astype(np.float32)).to(dev)
    la, lb = np.linalg.norm(a64, axis=1), np.linalg.norm(b64, axis=1)
    ua = a64 / la[:, None]
    ub = b64 / lb[:, None]
    cosv = (a64 * b64).sum(1) / (la * lb)
    ang = np.arccos(np.clip(cosv, -1.0, 1.0))
    rot = np.zeros((VEC_N, 3, 3))
    c, s = np.cos(th64), np.sin(th64)
    ux, uy, uz = ub[:, 0], ub[:, 1], ub[:, 2]
    rot[:, 0] = np.stack([c + ux * ux * (1 - c), ux * uy * (1 - c) - uz * s,
                          ux * uz * (1 - c) + uy * s], 1)
    rot[:, 1] = np.stack([uy * ux * (1 - c) + uz * s, c + uy * uy * (1 - c),
                          uy * uz * (1 - c) - ux * s], 1)
    rot[:, 2] = np.stack([uz * ux * (1 - c) - uy * s, uz * uy * (1 - c) + ux * s,
                          c + uz * uz * (1 - c)], 1)
    mag = np.maximum(la, lb)
    # float32 rounding: a few ulps of the operands' magnitude; an angle's
    # ulps of cos over sin(angle), floored where the vectors are collinear
    eps = float(np.finfo(np.float32).eps)
    cases = {
        "length": (lambda: V.length(a), la, 4 * eps * la),
        "to_unit": (lambda: V.to_unit(a), ua, 4 * eps),
        "dot": (lambda: V.dot(a, b), (a64 * b64).sum(1), 8 * eps * la * lb),
        "cross": (lambda: V.cross(a, b), np.cross(a64, b64), 8 * eps * (la * lb)[:, None]),
        "angle": (lambda: V.angle(a, b), ang,
                  1e-6 + 16 * eps / np.maximum(np.sin(ang), 1e-3)),
        "shift": (lambda: V.shift(a, b, d), a64 + ub * d64[:, None],
                  8 * eps * (la + np.abs(d64))[:, None]),
        "rotation_about_axis": (lambda: V.rotation_about_axis(b, th), rot, 16 * eps),
        "rotate": (lambda: V.rotate(a, V.rotation_about_axis(b, th)),
                   np.einsum("nij,nj->ni", rot, a64), 32 * eps * la[:, None]),
    }
    for name, (fn, want, tol) in cases.items():
        got = fn().cpu().double().numpy()
        tol = np.broadcast_to(np.asarray(tol, np.float64).reshape(
            np.shape(tol) + (1,) * (want.ndim - np.ndim(tol))), want.shape)
        gap = np.abs(got - want)
        if name == "angle":  # float32 |cos| past 1 gives NaN, as in the reference
            gap = np.where(np.isnan(got) & (1.0 - np.abs(cosv) < 8 * eps), 0.0, gap)
        ratio = float((gap / tol).max())
        ms = cuda_ms(fn, 5)
        check(ratio <= 1.0, f"vecmath.{name} on {VEC_N} vectors on the card within float64 "
              f"(largest gap {ratio:.3f} of its float32 bound; {ms:.4f} ms a call)")


def readers_phase(torch, xtc, offs, nat, box, system, dev):
    """Phase 18: the host readers and writers -> the K1/K2/K3 launches of its
    main path (the runner over every format, the profiled pass and the
    traced batch)."""
    from groan_rs_tpu_torch import testing
    from groan_rs_tpu_torch.core.simbox import SimBox
    from groan_rs_tpu_torch.io import native, serde, tng, traj, xtc_py
    from groan_rs_tpu_torch.models import TrajectoryAnalysis
    from groan_rs_tpu_torch.ops import kernels as K
    from groan_rs_tpu_torch.utils.profiling import PipelineProfiler, trace

    nf = min(READER_FRAMES, N_FRAMES)
    nt = min(TEXT_FRAMES, nf)
    ng = min(GZIP_TNG_FRAMES, nf)
    say(f"phase 18: the readers and writers, {nat} atoms x {nf} frames "
        f"(gzip TNG {ng}, text formats {nt})")
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    lay = testing.synthetic_layout(nat)
    n_prot, w0 = lay["n_prot"], lay["w0"]
    d = os.path.join(K.BUILD_DIR, "readers")
    os.makedirs(d, exist_ok=True)
    x, b9, _, _, prec = native.xtc_read_frames(xtc, offs[:nf], nat)
    _, steps, times, _ = native.xtc_scan(xtc)
    steps, times = steps[:nf], times[:nf]
    boxes = b9[:, [0, 4, 8]]
    secs = {}

    def lap(name, t0):
        if cuda:
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0

    def set_frame(f):
        system.positions[:] = x[f]
        system.has_position[:] = True
        system.set_box(SimBox.from_lengths(*map(float, boxes[f])))
        system.set_step(int(steps[f]))
        system.set_time(float(times[f]))
        system.set_precision(int(prec[f]))

    set_frame(0)
    runner = (TrajectoryAnalysis(system, device=dev)
              .add_com("Protein", name="com")
              .add_distance("Protein", "Membrane", com=(True, False), name="dist")
              .add_rmsd("Protein", reference=system, name="rmsd")
              .add_min_distance("Peptide", "Membrane", name="mindist")
              .runner(wire="f32"))
    stop = int(runner.sel[-1]) + 1
    keys = ("com", "dist", "rmsd", "mindist")

    def registry_write(path, frames, **kw):
        system.traj_writer_init(path, **kw)
        for f in range(frames):
            set_frame(f)
            system.traj_write_frame_to_file(path)
        system.traj_writer_close(path)

    # (name, path, frames, writer) in the order the phase runs them
    names = np.asarray(system.topology.atomname.values(), str)
    order = np.random.default_rng(180).permutation(nat)
    files = [
        ("TNG gzip", os.path.join(d, "gzip.tng"), ng,
         lambda p: registry_write(p, ng, codec="gzip")),
        ("TNG XTC2", os.path.join(d, "xtc2.tng"), nf,
         lambda p: registry_write(p, nf, codec="tng")),
        ("DCD", os.path.join(d, "a.dcd"), nf,
         lambda p: testing.write_dcd(p, x, boxes, istart=0, nsavc=10, delta=1.0)),
        ("Amber NetCDF", os.path.join(d, "a.nc"), nf,
         lambda p: testing.write_netcdf(p, x, boxes, times=times)),
        ("LAMMPS dump", os.path.join(d, "a.lammpstrj"), nt,
         lambda p: testing.write_lammpstrj(p, x[:nt], boxes[:nt], steps=steps[:nt],
                                           times=times[:nt] * 1000.0, units="real",
                                           order=order)),
        ("XYZ", os.path.join(d, "a.xyz"), nt, lambda p: registry_write(p, nt)),
        ("MOL2", os.path.join(d, "a.mol2"), nt,
         lambda p: testing.write_mol2(p, x[:nt], names, boxes[:nt])),
    ]
    for _, path, _, _ in files:
        if os.path.exists(path):
            os.unlink(path)

    # the format of each file: (times, steps) as the format defines them
    def want_frames(name, n):
        if name.startswith("TNG"):  # seconds in the frame set, back to ps
            return ((times[:n].astype(np.float64) * 1e-12 / 1e-12).astype(np.float32),
                    steps[:n])
        if name == "DCD":  # (istart + i nsavc) delta, the frame number
            return (np.arange(n) * 10 * np.float32(1.0)).astype(np.float32), np.arange(n)
        if name == "LAMMPS dump":  # TIME in fs ('real') times 1e-3
            return ((times[:n] * 1000.0).astype(np.float64) * 1e-3).astype(np.float32), \
                steps[:n]
        if name == "XYZ":  # the extended comment's Time=, %g of the System's time
            return np.float32([float(f"{float(t):g}") for t in times[:n]]), np.arange(n)
        return np.zeros(n, np.float32), np.arange(n)  # NetCDF, MOL2

    # ---- the phase's main path: the runner over every format ---------------
    K.reset_launch_counts()
    t0 = time.perf_counter()
    ref = runner.run(xtc, batch_size=BATCH, end_time=float(times[nf - 1]))
    lap(f"XTC pass f32 ({nf} frames)", t0)
    outs, sizes = {}, {}
    for name, path, n, write in files:
        t0 = time.perf_counter()
        write(path)
        lap(f"{name} write", t0)
        sizes[name] = os.path.getsize(path)
        t0 = time.perf_counter()
        outs[name] = runner.run(path, batch_size=BATCH)
        lap(f"{name} pass ({n} frames)", t0)
        src = traj.open_source(path)
        fb = src.read_batch(np.arange(n))
        outs[name]["boxes9"] = fb.boxes9
        outs[name]["src"] = (src.times, src.steps, src.natoms)
        if name != "TNG gzip":
            outs[name]["positions"] = fb.positions[:, :stop]
        os.unlink(path)
    prof = PipelineProfiler()
    t0 = time.perf_counter()
    prof_out = runner.run(xtc, batch_size=BATCH, profiler=prof)
    lap(f"profiled XTC pass ({N_FRAMES} frames)", t0)
    tdir = os.path.join(d, "trace")
    t0 = time.perf_counter()
    with trace(tdir):
        runner.run(xtc, batch_size=BATCH, end_time=float(times[min(BATCH, nf) - 1]))
    lap("traced batch", t0)
    counts = dict(K.launch_counts)

    # ---- what came out ---------------------------------------------------------
    say("  files: " + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in sizes.items()))
    for name, path, n, _ in files:
        out = outs[name]
        t_src, s_src, n_src = out["src"]
        wt, ws = want_frames(name, n)
        check(n_src == nat and np.array_equal(t_src, wt) and np.array_equal(s_src, ws)
              and np.array_equal(out["times"], wt) and np.array_equal(out["steps"], ws),
              f"{name}: {n} frames of {nat} atoms, times {t_src[:3].tolist()}... and steps "
              f"{s_src[:3].tolist()}... as the format defines them")
        bx = out["boxes9"]
        check(np.allclose(bx[:, :3], boxes[:n], rtol=0, atol=1e-6)
              and not bx[:, 3:].any(), f"{name}: boxes {bx[0, :3].tolist()} (the XTC's "
              "within 1e-6 nm, no off-diagonal)")
        if name == "TNG gzip":
            same = all(out[k].tobytes() == ref[k][:n].tobytes() for k in keys)
            check(same, f"{name}: COM, distance, RMSD and min distance equal the f32-wire "
                  "XTC pass bit for bit")
            continue
        gaps = {k: np.abs(out[k].astype(np.float64) - ref[k][:n]) for k in keys}
        pos_gap = float(np.abs(out["positions"] - x[:n, :stop]).max())
        worst = {k: float(v.max()) for k, v in gaps.items()}
        bad = [k for k, v in worst.items() if v > 1e-5]
        msg = (f"{name}: positions within {pos_gap:.2e} nm of the XTC's; COM, distance, "
               f"RMSD and min distance within " + ", ".join(
                   f"{k} {v:.2e}" for k, v in worst.items()))
        if not bad:
            check(True, msg + " (<= 1e-5)")
            continue
        # a gap above 1e-5 only where atoms take another unwrap image
        pa = torch.from_numpy(x[:n, :stop]).to(dev)
        pb = torch.from_numpy(np.ascontiguousarray(out["positions"])).to(dev)
        bx_t = torch.from_numpy(np.ascontiguousarray(boxes[:n])).to(dev)
        allowed = np.full(n, 1e-5)
        for grp, w in ((slice(0, n_prot), system.topology.mass[:n_prot]),
                       (slice(n_prot, stop), None)):
            ea = K.bai_breen_estimate(pa[:, grp], None, bx_t).cpu().numpy()
            eb = K.bai_breen_estimate(pb[:, grp], None, bx_t).cpu().numpy()
            moved, jump = testing.center_jump_bound(x[:n, grp], ea, eb, boxes[:n],
                                                    pos_b=out["positions"][:, grp], w=w)
            allowed += np.sqrt((jump ** 2).sum(1))
            say(f"    {'Protein' if w is not None else 'Membrane'}: atoms taking another "
                f"image per frame {moved.sum(1).tolist()}")
        del pa, pb
        ok = all((gaps[k].max(axis=tuple(range(1, gaps[k].ndim))) <= allowed).all()
                 for k in ("com", "dist")) and worst["rmsd"] <= 1e-5 \
            and worst["mindist"] <= 1e-5
        check(ok, msg + f": above 1e-5 only as far as image changes explain "
              f"(bound {allowed.max():.2e})")

    check(len(prof.batches) == -(-N_FRAMES // BATCH)
          and [b["n_frames"] for b in prof.batches] == [
              min(BATCH, N_FRAMES - i * BATCH) for i in range(len(prof.batches))]
          and all(prof_out[k][:nf].tobytes() == ref[k].tobytes() for k in keys),
          f"profiled pass: {prof.summary()}; its first {nf} frames equal the unprofiled "
          "pass")
    tfiles = [os.path.join(r, f) for r, _, fs in os.walk(tdir) for f in fs]
    tbytes = sum(os.path.getsize(f) for f in tfiles)
    check(len(tfiles) == 1 and tbytes > 0,
          f"trace() of one batch: {len(tfiles)} Chrome trace of {tbytes / 1e6:.2f} MB")
    for f in tfiles:
        os.unlink(f)

    # ---- GROAN_XTC_BACKEND=py ---------------------------------------------------
    os.environ["GROAN_XTC_BACKEND"] = "py"
    try:
        t0 = time.perf_counter()
        src = traj.XtcSource(xtc)
        scan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fb = src.read_batch(np.arange(1), stop_after=stop)
        py_s = time.perf_counter() - t0
    finally:
        del os.environ["GROAN_XTC_BACKEND"]
    t0 = time.perf_counter()
    nat_fb = traj.XtcSource(xtc).read_batch(np.arange(1), stop_after=stop)
    nat_s = time.perf_counter() - t0
    check(src._codec is xtc_py and not src.native_wire
          and all(getattr(fb, k).tobytes() == getattr(nat_fb, k).tobytes()
                  for k in ("positions", "boxes9", "steps", "times", "precisions")),
          f"GROAN_XTC_BACKEND=py: frame 0's first {stop} atoms bit for bit the native "
          f"codec's (Python scan {scan_s:.2f} s, decode {py_s:.2f} s; native "
          f"{nat_s:.3f} s)")
    secs["Python XTC decode, one frame"] = py_s

    # ---- System YAML -------------------------------------------------------------
    t0 = time.perf_counter()
    text = serde.system_to_yaml(system)
    t_emit = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = serde.system_from_yaml(text, device=dev)
    t_read = time.perf_counter() - t0
    ta, tb = system.topology, back.topology
    same = all(np.asarray(getattr(ta, k)).tobytes() == np.asarray(getattr(tb, k)).tobytes()
               for k in ("resnum", "atomnum", "charge", "has_charge", "mass", "has_mass",
                         "vdw", "has_vdw", "expected_min_bonds", "has_expected_min_bonds",
                         "expected_max_bonds", "has_expected_max_bonds"))
    same &= all(np.array_equal(getattr(ta, k).values(), getattr(tb, k).values())
                for k in ("resname", "atomname", "chain", "element_name", "element_symbol"))
    same &= np.array_equal(ta.bond_pairs(), tb.bond_pairs())
    for k, flag in (("positions", "has_position"), ("velocities", "has_velocity"),
                    ("forces", "has_force")):
        m = getattr(system, flag)
        same &= np.array_equal(m, getattr(back, flag)) and \
            getattr(system, k)[m].tobytes() == getattr(back, k)[m].tobytes()
    same &= list(system.groups) == list(back.groups) and all(
        np.array_equal(system.groups[g].atoms.blocks, back.groups[g].atoms.blocks)
        for g in system.groups)
    same &= (list(system.get_box()), system.get_step(), system.get_time(),
             system.get_precision(), system.get_lambda(), system.labeled_atoms) == \
        (list(back.get_box()), back.get_step(), back.get_time(), back.get_precision(),
         back.get_lambda(), back.labeled_atoms)
    check(same, f"System -> YAML -> System equal in every column ({len(text) / 1e6:.1f} MB "
          f"of text, {ta.bond_pairs().shape[0]} bonds; emit {t_emit:.1f} s, read "
          f"{t_read:.1f} s)")
    del text, back
    secs["YAML emit"], secs["YAML read"] = t_emit, t_read

    # ---- vecmath --------------------------------------------------------------------
    _vecmath_checks(torch, dev)

    # ---- launches ---------------------------------------------------------------------
    n_batches = (4 * -(-nf // BATCH) + -(-ng // BATCH) + 3 * -(-nt // BATCH)
                 + -(-N_FRAMES // BATCH) + 1)
    want = {"bai_breen_estimate": 4 * n_batches, "bai_breen_refine": 4 * n_batches,
            "pair_reduce": n_batches}
    if cuda:
        check(counts == want, f"K1, K2 and K3 launched as predicted ({counts}; {n_batches} "
              "batches: 4 centres and one min distance each)")
    else:
        no_launches(counts, "phase 18 on the CPU")
    say("  seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    say(f"  phase 18 seconds: {time.perf_counter() - t_phase:.1f}")
    return counts


MD_FRAMES = 24   # frames of the atoms-sharded passes (phase 4's first 24)
MH_LIMIT = 180   # seconds the two processes of the multi-host run may take
MAIN_REPS = 7    # interleaved timed rounds of the main path, single device and meshes
MD_TOL = 5e-5    # rtol and atol of the atoms-sharded results (the JAX test's)
MD_RMAX, MD_BINS = 2.0, 40

# one process of the multi-host run: phase 4's main path on its stripe,
# the merge, then a pass in which rank 1 raises at its second batch
MULTIHOST_CHILD = r"""
import sys
from datetime import timedelta

import numpy as np
import torch.distributed as dist

repo, rdv, xtc, out_path, device = sys.argv[1:6]
rank, world, batch = (int(a) for a in sys.argv[6:9])
sys.path.insert(0, repo)
from groan_rs_tpu_torch import convert, testing
from groan_rs_tpu_torch.errors import ParallelError
from groan_rs_tpu_torch.io import native
from groan_rs_tpu_torch.io.traj import traj_iter
from groan_rs_tpu_torch.models import TrajectoryAnalysis
from groan_rs_tpu_torch.parallel import merge_striped, striped_batches

dist.init_process_group("gloo", init_method="file://" + rdv, world_size=world,
                        rank=rank, timeout=timedelta(seconds=60))
offs, _, _, nat = native.xtc_scan(xtc)
c0, b9, *_ = native.xtc_read_frames(xtc, offs[:1], nat)
system = convert.system_from_state(testing.synthetic_state(c0[0], b9[0][[0, 4, 8]]),
                                   device=device)
runner = (TrajectoryAnalysis(system, device=device)
          .add_com("Protein", name="com")
          .add_distance("Protein", "Membrane", com=(True, False), name="dist")
          .add_rmsd("Protein", reference=system, name="rmsd")
          .add_min_distance("Peptide", "Membrane", name="mindist")).runner()


def stripe(fail_at):
    reader = traj_iter(system, xtc, indices=runner.sel, batch_size=batch)
    reader = reader.with_host_shard(rank, world)

    def batches():
        for i, fb in enumerate(reader.batches(wire=runner.wire)):
            if i == fail_at:
                raise RuntimeError(f"rank {rank} fails at its batch {i}")
            yield fb
    return striped_batches(batches(), -(-reader.n_selected() // batch))


out = runner.engine.run(stripe(-1))
merged = {k: merge_striped(out[k], world, rank) for k in ("com", "dist", "rmsd", "mindist")}
if rank == 0:
    np.savez(out_path, **merged)
print(f"rank {rank}: stripe of {len(out['com'])} frames merged", flush=True)
try:
    runner.engine.run(stripe(1 if rank == 1 else -1))
    code = 3
except ParallelError as e:
    print(f"rank {rank}: ParallelError: {e}", flush=True)
    code = 7
dist.destroy_process_group()
sys.exit(code)
"""


def _md_pipe(pipe, tri):
    """The JAX test suite's 12 observables (`tests/test_sharded_pipeline.py`
    `_pipeline`) on the synthetic groups: the pair observables take the
    Peptide against the Membrane; no density map on a triclinic box."""
    s = pipe.system
    pipe = (pipe.add_com("Protein", name="com")
            .add_distance("Protein", "Membrane", com=(True, False), name="distance")
            .add_rmsd("Protein", reference=s, name="rmsd")
            .add_min_distance("Peptide", "Membrane", name="mindist")
            .add_contacts("Peptide", "Membrane", cutoff=2.5, name="contacts")
            .add_rdf("Peptide", "Membrane", r_max=MD_RMAX, n_bins=MD_BINS, name="rdf"))
    if not tri:
        pipe = pipe.add_density_map("Membrane", plane="xy", tile=0.5, name="dens")
    return (pipe.add_gyration("Protein", name="gyr")
            .add_gyration("Protein", name="gyr4", components=True)
            .add_density_profile("Water", axis="z", n_bins=16, mode="mass", name="prof")
            .add_dipole("Protein", name="dip")
            .add_box_volume(name="vol"))


def _md_checks(got, want, boxes, n1, n2, what):
    """The JAX test's comparison: allclose at MD_TOL, contacts exact, the
    RDF within one count a bin (1.05 / ideal + MD_TOL in g(r))."""
    from groan_rs_tpu_torch.ops.distances import rdf_normalization

    keys = sorted(k for k in want if k not in ("times", "steps"))
    check(sorted(k for k in got if k not in ("times", "steps")) == keys
          and np.array_equal(got["times"], want["times"]), f"{what}: keys and times")
    worst = {}
    for k in keys:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        if k == "contacts":
            check(np.array_equal(g, w), f"{what} contacts equal ({int(w.sum())} in all)")
            continue
        if k == "rdf":
            ideal = rdf_normalization(boxes, n1, n2, MD_RMAX, MD_BINS).numpy()
            gap = np.abs(g - w).max()
            check(bool((np.abs(g - w) <= 1.05 / ideal + MD_TOL).all()),
                  f"{what} rdf within one count a bin (max diff {gap:.3e})")
            continue
        excess = np.abs(g - w) - (MD_TOL + MD_TOL * np.abs(w))
        worst[k] = float(np.abs(g - w).max())
        check(bool((excess <= 0).all()), f"{what} {k} within rtol and atol "
              f"{MD_TOL:g} (max diff {worst[k]:.3e})")
    return worst


def _multihost_run(torch, xtc, main_out, dev):
    """Two processes on the card, gloo over a file:// store -> seconds."""
    import tempfile

    from groan_rs_tpu_torch.ops import kernels as K

    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(dir=K.BUILD_DIR)
    rdv, npz = os.path.join(tmp, "rdv"), os.path.join(tmp, "merged.npz")
    env = dict(os.environ, OMP_NUM_THREADS="2", GLOO_SOCKET_IFNAME="lo")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MULTIHOST_CHILD, repo, rdv, xtc, npz, str(dev), str(r),
         "2", str(BATCH)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs, codes = [], []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, MH_LIMIT - (time.perf_counter() - t0)))[0])
            codes.append(p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    secs = time.perf_counter() - t0
    for r, log in enumerate(logs):
        for line in log.strip().splitlines()[-4:]:
            say(f"  [rank {r}] {line}")
    check(len(codes) == 2, f"both processes ended within {MH_LIMIT} s")
    check(codes == [7, 7], f"both ranks ended with ParallelError after rank 1 failed "
          f"(exit codes {codes}, 7 = ParallelError)")
    check("rank 1 fails at its batch 1" in logs[1] and "a peer host failed" in logs[0],
          "rank 1 raised its own error, rank 0 the peer flag")
    merged = dict(np.load(npz))
    for k in ("com", "dist", "mindist"):
        check(np.array_equal(merged[k], main_out[k]),
              f"merged stripes' {k} equals phase 4's bit for bit")
    e = float(np.abs(merged["rmsd"].astype(np.float64) - main_out["rmsd"]).max())
    check(e <= 2e-5, f"merged stripes' rmsd within 2e-5 of phase 4's ({e:.1e})")
    return secs


def multidevice_phase(torch, xtc, main_system, main_out, main_s, obs_system,
                      tri_system, dev):
    """Phase 19 -> (launch counts of the phase, of its sharded passes)."""
    from groan_rs_tpu_torch import testing
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.models import TrajectoryAnalysis
    from groan_rs_tpu_torch.ops import kernels as K
    from groan_rs_tpu_torch.parallel import make_mesh

    say(f"phase 19: multi-device, {N_ATOMS} atoms, meshes over the one card")
    total = dict.fromkeys(K.launch_counts, 0)
    sharded = dict.fromkeys(K.launch_counts, 0)

    def counted(fn, into=(), want=None, what=""):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = dict(K.launch_counts)
        for acc in (total,) + tuple(into):
            for k, v in got.items():
                acc[k] += v
        if want is not None:
            check(got == dict(zip(("bai_breen_estimate", "bai_breen_refine",
                                   "pair_reduce"), want)),
                  f"{what}: launches {got} as predicted")
        return res, secs

    meshes = {"default": make_mesh(), "2x1": make_mesh(2, 1, devices=[dev] * 2),
              "1x4": make_mesh(1, 4, devices=[dev] * 4),
              "2x2": make_mesh(2, 2, devices=[dev] * 4)}
    n_cards = torch.cuda.device_count()
    check(meshes["default"].shape == {"frames": n_cards, "atoms": 1},
          f"make_mesh() puts the {n_cards} card(s) on the frames axis")
    for name, m in meshes.items():
        say(f"  mesh {name}: {m}")

    # ---- the frames-sharded main path
    def main_pipe(mesh):
        return (TrajectoryAnalysis(main_system, mesh=mesh)
                .add_com("Protein", name="com")
                .add_distance("Protein", "Membrane", com=(True, False), name="dist")
                .add_rmsd("Protein", reference=main_system, name="rmsd")
                .add_min_distance("Peptide", "Membrane", name="mindist"))

    n_b = -(-N_FRAMES // BATCH)
    shard_out = {}
    for name, f in (("default", n_cards), ("2x1", 2)):
        runner = main_pipe(meshes[name]).runner()
        runner.run(xtc, batch_size=BATCH)  # first pass: allocations
        out, secs = counted(lambda: runner.run(xtc, batch_size=BATCH), (sharded,),
                            (4 * f * n_b, 4 * f * n_b, f * n_b),
                            f"main path on mesh {name}")
        say(f"  main path on mesh {name}: {secs:.4f} s = {N_FRAMES / secs:.2f} "
            f"frames/s (phase 4 single device {main_s:.4f} s)")
        for k in ("com", "dist", "mindist"):
            check(np.array_equal(out[k], main_out[k]),
                  f"mesh {name} {k} equals phase 4's bit for bit")
        e = float(np.abs(out["rmsd"].astype(np.float64) - main_out["rmsd"]).max())
        check(e <= 2e-5, f"mesh {name} rmsd within 2e-5 of phase 4's ({e:.1e})")
        shard_out[name] = (runner, out)

    # ---- the main path's time: single device, make_mesh() and 2x1 in
    # MAIN_REPS interleaved rounds, outside the counted passes
    timed = {"single device": main_pipe(None).runner(),
             "mesh default": shard_out["default"][0], "mesh 2x1": shard_out["2x1"][0]}
    timed["single device"].run(xtc, batch_size=BATCH)  # first pass: allocations
    reps = {k: [] for k in timed}
    for _ in range(MAIN_REPS):
        for k, r in timed.items():
            t0 = time.perf_counter()
            r.run(xtc, batch_size=BATCH)
            torch.cuda.synchronize()
            reps[k].append(time.perf_counter() - t0)
    K.reset_launch_counts()
    for k, t in reps.items():
        say(f"  main path {k}, {MAIN_REPS} interleaved passes: median "
            f"{float(np.median(t)):.4f} s, min {min(t):.4f}, max {max(t):.4f} "
            f"({float(np.median(t)) / float(np.median(reps['single device'])):.3f}x "
            f"the single device)")

    # ---- its resident re-runs, on the single-device sibling engine
    runner, streamed = shard_out["2x1"]
    dt = runner.load_device(xtc, batch_size=BATCH)
    sibling = runner._engine_1dev()
    check(sibling is not runner.engine and sibling.n_shards == 1
          and sibling.device == dev, "the 2x1 runner's resident engine is a "
          "single-device sibling on the mesh's first device")
    for label, fn in (("run_resident_fused", sibling.run_resident_fused),
                      ("run_resident", sibling.run_resident)):
        res, secs = counted(lambda: fn(dt, batch_size=BATCH), (sharded,),
                            (4 * n_b, 4 * n_b, n_b), f"2x1 {label}")
        worst = max(float(np.abs(res[k].astype(np.float64) - streamed[k]).max())
                    for k in ("com", "dist", "rmsd", "mindist"))
        check(worst <= 1e-6, f"2x1 {label} equals the streamed sharded pass "
              f"(max diff {worst:.1e}; {secs:.4f} s)")
    via_run = runner.run(dt, batch_size=BATCH)
    check(all(np.array_equal(via_run[k], streamed[k]) or
              float(np.abs(via_run[k].astype(np.float64) - streamed[k]).max()) <= 1e-6
              for k in ("com", "dist", "rmsd", "mindist")),
          "the 2x1 runner's run(dt) equals its streamed pass")
    del dt

    # ---- the atoms-sharded runner at full width
    t_end = float(main_out["times"][MD_FRAMES - 1])
    n_prot, n_mem = testing.synthetic_sizes(N_ATOMS)
    n_pep = min(400, n_prot)
    offs, _, _, nat = native.xtc_scan(xtc)
    b9 = native.xtc_read_frames(xtc, offs[:MD_FRAMES], nat, stop_after=1)[1]
    boxes = b9[:, [0, 4, 8]]
    single_runner = _md_pipe(TrajectoryAnalysis(obs_system, device=dev), False).runner(ship="all")
    single_runner.run(xtc, batch_size=BATCH, end_time=t_end)
    single, s_secs = counted(lambda: single_runner.run(xtc, batch_size=BATCH, end_time=t_end))
    say(f"  single-device 12-observable pass over {MD_FRAMES} frames: {s_secs:.4f} s")
    md_batches = -(-MD_FRAMES // BATCH)
    atoms_out = {}
    for name, rows in (("1x4", 1), ("2x2", 2)):
        runner = _md_pipe(TrajectoryAnalysis(obs_system, mesh=meshes[name]), False).runner()
        check(runner.wire == "q16" and runner.engine._spec is not None,
              f"mesh {name}: the atoms-sharded runner on the q16 wire")
        runner.run(xtc, batch_size=BATCH, end_time=t_end)
        # K3 once a batch per frames row and pair observable (mindist,
        # contacts): the Peptide lies in the first atoms shard only
        out, secs = counted(lambda: runner.run(xtc, batch_size=BATCH, end_time=t_end),
                            (sharded,), (0, 0, 2 * rows * md_batches),
                            f"atoms-sharded pass on {name}")
        say(f"  atoms-sharded pass on {name} over {MD_FRAMES} frames: {secs:.4f} s "
            f"(single device {s_secs:.4f} s)")
        _md_checks(out, single, boxes, n_pep, n_mem, f"{name} vs single device")
        atoms_out[name] = out
    f32_runner = _md_pipe(TrajectoryAnalysis(obs_system, mesh=meshes["2x2"]),
                          False).runner(wire="f32")
    f32, secs = counted(lambda: f32_runner.run(xtc, batch_size=BATCH, end_time=t_end),
                        (sharded,), (0, 0, 4 * md_batches), "2x2 pass on the f32 wire")
    gap = max(float(np.abs(np.asarray(f32[k], np.float64) - atoms_out["2x2"][k]).max())
              for k in f32 if k not in ("times", "steps"))
    check(gap <= 1e-6, f"2x2 f32 wire equals the q16 wire (max diff {gap:.1e}; "
          f"{secs:.4f} s)")

    # ---- the triclinic atoms-sharded step, one batch of phase 9's file
    txtc = triclinic_xtc(BATCH)
    toffs, _, _, tnat = native.xtc_scan(txtc)
    tb9 = native.xtc_read_frames(txtc, toffs, tnat, stop_after=1)[1]
    tri_single = _md_pipe(TrajectoryAnalysis(tri_system, device=dev, triclinic=True),
                          True).runner(ship="all")
    want, s_secs = counted(lambda: tri_single.run(txtc, batch_size=BATCH))
    tri_mesh = _md_pipe(TrajectoryAnalysis(tri_system, mesh=meshes["2x2"],
                                           triclinic=True), True).runner()
    got, secs = counted(lambda: tri_mesh.run(txtc, batch_size=BATCH), (sharded,),
                        (0, 0, 0), "triclinic atoms-sharded pass")
    say(f"  triclinic 2x2 pass, {BATCH} frames: {secs:.4f} s (single device "
        f"{s_secs:.4f} s)")
    _md_checks(got, want, tb9.reshape(-1, 3, 3), n_pep, n_mem, "triclinic 2x2 vs single")

    # ---- two processes on the card
    secs = _multihost_run(torch, xtc, main_out, dev)
    say(f"  multi-host run (2 processes, spawn to exit, 2 passes each): {secs:.1f} s")
    say(f"  phase 19 launches {total}; of its sharded passes {sharded}")
    return total, sharded


CLI_TRJ_FRAMES = 6   # frames of phase 20's trjconv time window (phase 4's frames 2-7)
CLI_BATCH = 32       # the CLI's default --batch-size


def _xvg_digits(cols):
    """Columns as the CLI's XVG files hold them (`%14.8g`) -> [rows, cols]."""
    return np.array([[float(f"{v:14.8g}") for v in row]
                     for row in zip(*[np.asarray(c, np.float64) for c in cols])])


def _cli_call(torch, cli, argv, guess):
    """One in-process call of the CLI's `main` -> seconds {"total", "read"
    (its structure read: GRO + NDX), "guess"}.  `guess`: elements, and so
    masses, are guessed after the read, as phase 10 guesses them (GRO has no
    masses, and the CLI reads them from TPR files only)."""
    import warnings

    orig, secs = cli._system, {"read": 0.0, "guess": 0.0}

    def _system(args):
        t0 = time.perf_counter()
        s = orig(args)
        secs["read"] += time.perf_counter() - t0
        if guess:
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                s.guess_elements()
            secs["guess"] += time.perf_counter() - t0
        return s

    cli._system = _system
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        secs["total"] = time.perf_counter() - t0
    finally:
        cli._system = orig
    check(rc == 0, f"{argv[0]} returned 0 ({secs['total']:.2f} s)")
    return secs


def cli_phase(torch, xtc):
    """Phase 20: the gmx-style CLI (`cli.py`) on phase 10's GRO and NDX and
    phase 4's XTC, with no --device -> the K1/K2/K3 launches of its tool
    runs (the API's equal calls launch as many)."""
    import shutil
    import warnings

    from groan_rs_tpu_torch import System, cli
    from groan_rs_tpu_torch.core.dimension import Dimension
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.io.xvg import read_xvg
    from groan_rs_tpu_torch.models import TrajectoryAnalysis
    from groan_rs_tpu_torch.models.convert import CenterConverter, convert_iter
    from groan_rs_tpu_torch.ops import kernels as K

    say(f"phase 20: the command line (groan_rs_tpu_torch.cli), {N_ATOMS} atoms x "
        f"{N_FRAMES} frames")
    gro = os.path.join(K.BUILD_DIR, f"smoke_{N_ATOMS}.gro")
    ndx = os.path.join(K.BUILD_DIR, f"smoke_{N_ATOMS}.ndx")
    out_dir = os.path.join(K.BUILD_DIR, "cli")
    os.makedirs(out_dir, exist_ok=True)
    times = native.xtc_scan(xtc)[2]
    t_lo, t_hi = float(times[2]), float(times[1 + CLI_TRJ_FRAMES])
    base = ["-s", gro, "-n", ndx, "-f", xtc]
    tools = {  # tool -> (its options, guess elements after the read)
        "rms": (["--sel", "Protein"], True),
        "distance": (["--sel", "Protein", "--ref", "Membrane"], False),
        "mindist": (["--sel", "Peptide", "--ref", "Membrane"], False),
        "gyrate": (["--sel", "Protein"], True),
        "trjconv": (["--sel", "Protein", "--center", "Protein", "-b", f"{t_lo:g}",
                     "-e", f"{t_hi:g}"], False)}
    outs = {t: os.path.join(out_dir, f"{t}.{'xtc' if t == 'trjconv' else 'xvg'}")
            for t in tools}

    # ---- the tools, as a user types them: no --device --------------------
    K.reset_launch_counts()
    secs = {t: _cli_call(torch, cli, [t, *base, *extra, "-o", outs[t]], guess)
            for t, (extra, guess) in tools.items()}
    cli_counts = dict(K.launch_counts)

    # ---- the same calls through the API ----------------------------------
    t0 = time.perf_counter()
    s = System.from_file(gro)
    t_gro = time.perf_counter() - t0
    s.read_ndx(ndx)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s.guess_elements()
    K.reset_launch_counts()
    api, api_s = {}, {}
    for tool, build, key in (
            ("rms", lambda p: p.add_rmsd("Protein", s, name="r"), "r"),
            ("distance", lambda p: p.add_distance("Protein", "Membrane",
                                                  dim=Dimension.from_string("xyz"),
                                                  name="d"), "d"),
            ("mindist", lambda p: p.add_min_distance("Peptide", "Membrane", name="d"), "d"),
            ("gyrate", lambda p: p.add_gyration("Protein", name="rg", components=False),
             "rg")):
        t0 = time.perf_counter()
        pipe = TrajectoryAnalysis(s)
        build(pipe)
        out = pipe.run(xtc, batch_size=CLI_BATCH)
        api_s[tool] = time.perf_counter() - t0
        api[tool] = _xvg_digits([out["times"], out[key]])
    api_xtc = os.path.join(out_dir, "trjconv_api.xtc")
    t0 = time.perf_counter()
    reader = s.traj_iter(xtc, start_time=t_lo, end_time=t_hi, step=None,
                         batch_size=CLI_BATCH)
    s.group_traj_writer_init("Protein", api_xtc)
    try:
        for _ in convert_iter(reader, [CenterConverter("Protein")]):
            s.traj_write_frame()
    finally:
        s.traj_writers_close()
    torch.cuda.synchronize()
    api_s["trjconv"] = time.perf_counter() - t0
    api_counts = dict(K.launch_counts)

    for tool in ("rms", "distance", "mindist", "gyrate"):
        got = read_xvg(outs[tool])
        check(got.shape == (N_FRAMES, 2) and np.array_equal(got, api[tool]),
              f"{tool}: the CLI's XVG equals the API call's series to its 8 digits "
              f"({got.shape[0]} frames, batch {CLI_BATCH})")
    with open(outs["trjconv"], "rb") as a, open(api_xtc, "rb") as b:
        same = a.read() == b.read()
    n_trj = len(native.xtc_scan(outs["trjconv"])[2])
    check(same and n_trj == CLI_TRJ_FRAMES,
          f"trjconv: the CLI's XTC ({n_trj} frames of the Protein, centred) equals the "
          "API's convert_iter output byte for byte")
    for k, v in cli_counts.items():
        check(v > 0 and v == api_counts[k],
              f"{k} launched {v} times by the CLI's tools, as by the API's calls "
              f"({api_counts[k]})")

    # ---- once more through the entry point, in a process of its own ------
    sub_out = os.path.join(out_dir, "mindist_sub.xvg")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "groan_rs_tpu_torch", "mindist", *base, "--sel", "Peptide",
         "--ref", "Membrane", "-o", sub_out],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=300)
    t_sub = time.perf_counter() - t0
    check(proc.returncode == 0, f"python -m groan_rs_tpu_torch mindist returned 0 "
          f"({t_sub:.1f} s, start to exit){proc.stderr[-2000:]}")
    with open(outs["mindist"], "rb") as a, open(sub_out, "rb") as b:
        check(a.read() == b.read(), "its XVG equals the in-process call's byte for byte")

    say(f"  the GRO read alone: {t_gro:.2f} s")
    for tool, sec in secs.items():
        say(f"  {tool}: {sec['total']:.2f} s, of which the structure read (GRO + NDX) "
            f"{sec['read']:.2f} s and guess_elements {sec['guess']:.2f} s; "
            f"the API call {api_s[tool]:.2f} s")
    say(f"  phase 20 launches {cli_counts} (the subprocess's own are not counted)")
    shutil.rmtree(out_dir)
    return cli_counts


TPR_ORACLE_FRAMES = 8   # frames of phase 21's float64 oracles of the main path


def _tpr_fields(s, src, nat):
    """Phase 21: the System read from the TPR against the one written."""
    from groan_rs_tpu_torch import testing

    tt, ts = s.topology, src.topology
    for f in ("resname", "atomname", "element_name", "element_symbol"):
        check(np.array_equal(getattr(tt, f).values(), getattr(ts, f).values()),
              f"{f}: every atom's equals the written System's")
    for f in ("resnum", "atomnum", "mass", "charge", "has_mass", "has_charge"):
        check(np.array_equal(getattr(tt, f), getattr(ts, f)),
              f"{f}: every atom's equals the written System's")
    check(bool(tt.has_mass.all() and tt.has_charge.all()), "every atom has a mass and a charge")
    pairs = tt.bond_pairs()
    check(np.array_equal(pairs, ts.bond_pairs()),
          f"bonds equal the written System's ({pairs.shape[0]} bonds)")
    n_prot, n_mem = testing.synthetic_sizes(nat)
    n_wat = nat - n_prot - n_mem
    want = n_prot // 10 + n_mem // 50 + n_wat // 3 + (n_wat % 3 > 0)
    got = tt.n_molecules()
    check(got == ts.n_molecules() == want,
          f"{got} molecules: the protein's residues, the lipids, the waters and the lone OW")
    for f in ("positions", "velocities", "has_position", "has_velocity"):
        check(np.array_equal(getattr(s, f), getattr(src, f)),
              f"{f} equal the written System's bit for bit")
    check(list(s.get_box()) == list(src.get_box()) and s.name == src.name
          and s.lambda_ == 0.0, "box, name and lambda equal the written System's")


def _whole_checks(s, box):
    """Phase 21: `make_molecules_whole` moves atoms by whole box vectors
    only and leaves every bond within half a box length on each axis."""
    box64 = np.asarray(box, np.float64)
    old = s.positions.copy()
    pairs = s.topology.bond_pairs()
    before = float(np.abs(old[pairs[:, 1]] - old[pairs[:, 0]]).max())
    t0 = time.perf_counter()
    s.make_molecules_whole()
    t = time.perf_counter() - t0
    new = s.positions.astype(np.float64)
    d = np.abs(new[pairs[:, 1]] - new[pairs[:, 0]]) / box64
    shift = (new - old) / box64
    off = float(np.abs(shift - np.rint(shift)).max())
    check(float(d.max()) <= 0.5 + 1e-6 and off <= 1e-5,
          f"make_molecules_whole ({t:.2f} s): every bond within half a box length on each "
          f"axis (largest {float(d.max()):.6f} L; before {before:.3f} nm), atoms moved by "
          f"whole box vectors (within {off:.1e} L), {int((np.rint(shift) != 0).any(1).sum())} "
          "atoms moved")
    s.positions[:] = old


def _dump_text(path, s):
    """What `dump -s path` prints of the System `s`."""
    topo, n = s.topology, s.get_n_atoms()
    m = np.asarray(s.get_box().to_matrix(), np.float64)
    lines = [f"{path}:", f"  natoms = {n}",
             f"  box (nm) = [{m[0, 0]:.5f} {m[1, 1]:.5f} {m[2, 2]:.5f}]",
             f"  bonds = {topo.bond_pairs().shape[0]}", "  groups = All, all"]
    for i in range(min(10, n)):
        x = s.positions[i]
        lines.append(f"  atom {i}: {topo.resnum[i]} {topo.resname.get(i)} "
                     f"{topo.atomname.get(i)} (#{topo.atomnum[i]}) "
                     f"m={float(topo.mass[i]):.4f} q={float(topo.charge[i]):+.4f} "
                     f"x=({x[0]:.4f} {x[1]:.4f} {x[2]:.4f})")
    return "\n".join(lines + [f"  ... {n - 10} more atoms"]) + "\n"


def tpr_phase(torch, xtc, offs, nat, frame0, box, main_out):
    """Phase 21: the TPR reader (`io/tpr.py`) on the 1M-atom System written
    by the test encoder, over phase 4's XTC -> the K1/K2/K3 launches of its
    path (the main path, whole molecules and the CLI's tools)."""
    import contextlib
    import io
    import shutil

    from groan_rs_tpu_torch import System, cli, testing
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.io.xvg import read_xvg
    from groan_rs_tpu_torch.models import TrajectoryAnalysis
    from groan_rs_tpu_torch.models.convert import MakeWholeConverter, convert_iter
    from groan_rs_tpu_torch.ops import kernels as K

    say(f"phase 21: TPR files (groan_rs_tpu_torch/io/tpr.py), {nat} atoms x {N_FRAMES} frames")
    out_dir = os.path.join(K.BUILD_DIR, "tpr")
    os.makedirs(out_dir, exist_ok=True)
    tpr = os.path.join(out_dir, f"smoke_{nat}.tpr")
    ndx = os.path.join(K.BUILD_DIR, f"smoke_{nat}.ndx")
    n_prot, n_mem = testing.synthetic_sizes(nat)
    vel = (np.random.default_rng(21).normal(size=(nat, 3)) * 0.4).astype(np.float32)

    # ---- the file: phase 4's frame 0 with names, masses, charges, bonds ---
    src, mols = testing.synthetic_tpr_system(frame0, box, velocities=vel, device="cpu")
    t0 = time.perf_counter()
    testing.write_tpr_system(tpr, src, mols)
    t_write = time.perf_counter() - t0
    say(f"  encoded {os.path.getsize(tpr) / 1e6:.1f} MB in {t_write:.2f} s; molecule "
        f"blocks {[m[:3] for m in mols]}")
    t0 = time.perf_counter()
    s = System.from_file(tpr)
    t_read = time.perf_counter() - t0
    say(f"  System.from_file: {t_read:.2f} s")
    check(s.device.type == "cuda", f"the System read with no device computes on {s.device}")
    _tpr_fields(s, src, nat)

    # ---- the main path on the TPR's masses --------------------------------
    s.read_ndx(ndx)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = (TrajectoryAnalysis(s)
           .add_com("Protein", name="com")
           .add_distance("Protein", "Membrane", com=(True, False), name="dist")
           .add_rmsd("Protein", reference=s, name="rmsd")
           .add_min_distance("Peptide", "Membrane", name="mindist")
           .run(xtc, batch_size=BATCH))
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    main_counts = dict(K.launch_counts)
    say(f"  the main path: {t_main:.2f} s, launches {main_counts}")
    coords = native.xtc_read_frames(xtc, offs[:TPR_ORACLE_FRAMES], nat,
                                    stop_after=n_prot + n_mem)[0]
    main_path_checks(out, frame0, coords, box, src.topology.mass[:n_prot], n_prot,
                     "TPR masses: ")
    check(np.array_equal(out["mindist"], main_out["mindist"]),
          "mindist equals phase 4's bit for bit")
    _whole_checks(s, box)

    # ---- the tools, as a user types them: no --device ----------------------
    times = native.xtc_scan(xtc)[2]
    t_lo, t_hi = float(times[2]), float(times[1 + CLI_TRJ_FRAMES])
    base = ["-s", tpr, "-n", ndx, "-f", xtc]
    tools = {"rms": ["--sel", "Protein"], "gyrate": ["--sel", "Protein"],
             "mindist": ["--sel", "Peptide", "--ref", "Membrane"],
             "trjconv": ["--sel", "Protein", "--pbc", "whole", "-b", f"{t_lo:g}",
                         "-e", f"{t_hi:g}"]}
    outs = {t: os.path.join(out_dir, f"{t}.{'xtc' if t == 'trjconv' else 'xvg'}")
            for t in tools}
    secs = {t: _cli_call(torch, cli, [t, *base, *extra, "-o", outs[t]], False)
            for t, extra in tools.items()}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["dump", "-s", tpr])
    secs["dump"] = {"total": time.perf_counter() - t0}
    check(rc == 0, f"dump returned 0 ({secs['dump']['total']:.2f} s)")
    counts = dict(K.launch_counts)
    cli_counts = {k: counts[k] - main_counts[k] for k in counts}

    # ---- the same calls through the API ------------------------------------
    K.reset_launch_counts()
    for tool, build, key in (
            ("rms", lambda p: p.add_rmsd("Protein", s, name="r"), "r"),
            ("gyrate", lambda p: p.add_gyration("Protein", name="rg", components=False),
             "rg"),
            ("mindist", lambda p: p.add_min_distance("Peptide", "Membrane", name="d"), "d")):
        pipe = TrajectoryAnalysis(s)
        build(pipe)
        o = pipe.run(xtc, batch_size=CLI_BATCH)
        got = read_xvg(outs[tool])
        check(got.shape == (N_FRAMES, 2)
              and np.array_equal(got, _xvg_digits([o["times"], o[key]])),
              f"{tool} -s x.tpr: the CLI's XVG equals the API call's series to its 8 digits")
    api_xtc = os.path.join(out_dir, "trjconv_api.xtc")
    reader = s.traj_iter(xtc, start_time=t_lo, end_time=t_hi, step=None,
                         batch_size=CLI_BATCH)
    s.group_traj_writer_init("Protein", api_xtc)
    try:
        for _ in convert_iter(reader, [MakeWholeConverter()]):
            s.traj_write_frame()
    finally:
        s.traj_writers_close()
    api_counts = dict(K.launch_counts)
    with open(outs["trjconv"], "rb") as a, open(api_xtc, "rb") as b:
        same = a.read() == b.read()
    n_trj = len(native.xtc_scan(outs["trjconv"])[2])
    check(same and n_trj == CLI_TRJ_FRAMES,
          f"trjconv --pbc whole -s x.tpr: the CLI's XTC ({n_trj} frames of the Protein, "
          "molecules whole) equals the API's convert_iter output byte for byte")
    s.positions[:] = frame0
    want = _dump_text(tpr, s)
    check(buf.getvalue() == want, "dump -s x.tpr prints the API System's fields "
          f"({len(want.splitlines())} lines)")
    for k, v in cli_counts.items():
        check(v == api_counts[k], f"{k} launched {v} times by the CLI's tools, as by the "
              f"API's calls ({api_counts[k]})")
    for k, v in counts.items():
        check(v > 0, f"{k} launched on phase 21's path ({v})")

    for tool, sec in secs.items():
        say(f"  {tool} -s x.tpr: {sec['total']:.2f} s" + ("" if tool == "dump" else
            f", of which the structure read (TPR + NDX) {sec['read']:.2f} s"))
    say(f"  phase 21 launches {counts}: main path {main_counts}, CLI tools {cli_counts}")
    shutil.rmtree(out_dir)
    return counts


def _streamed_passes(torch, runner, xtc):
    """Two streamed passes of `runner` over `xtc` -> (the last one's
    results, the seconds of each, the seconds of the last one's packed
    fetch: its `fetch` span, that pass run with the port's tracing on)."""
    from groan_rs_tpu_torch.utils import profiling

    passes = []
    for traced in (False, True):
        with profiling.tracing() if traced else contextlib.nullcontext() as rec:
            t0 = time.perf_counter()
            out = runner.run(xtc, batch_size=BATCH)
            torch.cuda.synchronize()
            passes.append(time.perf_counter() - t0)
    fetch_s = sum(sp.seconds for sp in rec.take()[0] if sp.name == "fetch")
    return out, passes, fetch_s


def _sync_count(torch, fn):
    """Host synchronisations `fn()` makes on the card, counted by
    `torch.cuda.set_sync_debug_mode("warn")`'s warnings."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in seen)


def _first_sync(torch, fn):
    """"file:line: code" of the port's frame that made `fn()`'s first host
    synchronisation (`set_sync_debug_mode("error")`), or None."""
    import traceback

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        tb = traceback.extract_tb(e.__traceback__)
        f = ([f for f in tb if "groan_rs_tpu_torch" in f.filename] or tb)[-1]
        return f"{f.filename.split('groan_rs_tpu_torch/')[-1]}:{f.lineno}: {f.line}"
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return None


API_SAMPLE = 2000   # atoms whose PDB lines phase 22 compares with the writer's


def api_phase(torch, runner, dt, xtc, system, resident):
    """Phase 22: the resident main path with a fold on the card over phase
    5's window, and the host names of the public API on the 1M-atom
    System -> the K1/K2/K3 launches of its five folded and unfolded
    passes.  `resident` is phase 5's `run_resident` result."""
    import groan_rs_tpu_torch as root
    from groan_rs_tpu_torch import TrajectoryAnalysis, prelude
    from groan_rs_tpu_torch.core.shapes import Sphere
    from groan_rs_tpu_torch.io.pdb import format_pdb_atom_line
    from groan_rs_tpu_torch.ops import kernels as K
    from groan_rs_tpu_torch.system import Group

    say(f"phase 22: the rest of the public API, run_resident(fold=) over {dt.n_frames} "
        f"resident frames x {dt.pos.shape[1]} atoms")
    eng, dev = runner.engine, dt.pos.device
    inf = torch.full((), float("inf"), device=dev)

    def fold(carry, out, mask):
        m = mask.to(torch.float32)
        return {"com": carry["com"] + (out["com"] * m[:, None]).sum(0),
                "dist": carry["dist"] + (out["dist"] * m).sum(),
                "rmsd": carry["rmsd"] + (out["rmsd"] * m).sum(),
                "mindist": torch.minimum(carry["mindist"],
                                         torch.where(mask, out["mindist"], inf).min()),
                "n": carry["n"] + mask.sum()}

    def init():
        z = torch.zeros((), device=dev)
        return {"com": torch.zeros(3, device=dev), "dist": z, "rmsd": z.clone(),
                "mindist": inf.clone(), "n": torch.zeros((), dtype=torch.int64, device=dev)}

    def host(carry):
        return {k: v.double().cpu().numpy() for k, v in carry.items()}

    K.reset_launch_counts()
    t0 = time.perf_counter()
    none, carry = eng.run_resident(dt, batch_size=BATCH, collect=False, fold=fold,
                                   init=init())
    torch.cuda.synchronize()
    t_fold = time.perf_counter() - t0
    check(none is None and carry["n"].device == dev,
          f"collect=False returns None and the carry on {dev} ({t_fold:.4f} s)")
    t0 = time.perf_counter()
    got, carry2 = eng.run_resident(dt, batch_size=BATCH, fold=fold, init=init())
    t_both = time.perf_counter() - t0
    c, c2 = host(carry), host(carry2)
    check(all(np.array_equal(c[k], c2[k]) for k in c),
          f"the carry of collect=True equals collect=False's ({t_both:.4f} s with the fetch)")
    check(all(np.array_equal(got[k], resident[k]) for k in ("com", "dist", "rmsd", "mindist")),
          "collect=True's results equal phase 5's run_resident bit for bit")
    check(int(c["n"]) == dt.n_frames and c["mindist"] == got["mindist"].min(),
          f"the carry's minimum {float(c['mindist']):.6f} nm is the collected minimum, "
          f"exactly, over {int(c['n'])} frames")
    sums = {"com": got["com"].astype(np.float64).sum(0),
            "dist": got["dist"].astype(np.float64).sum(),
            "rmsd": got["rmsd"].astype(np.float64).sum()}
    e = max(float(np.abs(c[k] - v).max() / np.abs(v).max()) for k, v in sums.items())
    check(e <= 1e-5, f"the carry's sums within {e:.1e} (relative) of the host fold "
          f"in float64 (limit 1e-5)")
    reader = runner._reader(xtc, BATCH)
    t0 = time.perf_counter()
    snone, scarry = eng.run(reader.batches(wire=runner.wire), fold=fold, init=init(),
                            collect=False)
    t_stream = time.perf_counter() - t0
    sc = host(scarry)
    e_min = abs(float(sc["mindist"] - c["mindist"]))
    e_sum = max(float(np.abs(sc[k] - c[k]).max() / np.abs(c[k]).max()) for k in sums)
    check(snone is None and int(sc["n"]) == dt.n_frames and e_min <= 1e-6 and e_sum <= 1e-5,
          f"the streamed run(fold=) carry: minimum within {e_min:.1e} (1e-6), sums within "
          f"{e_sum:.1e} relative (1e-5) of the resident carry ({t_stream:.4f} s)")

    # host synchronisation: the fold alone on one batch's outputs, and the
    # folded loop against the loop without it
    one = {k: torch.from_numpy(np.ascontiguousarray(v[:BATCH])).to(dev)
           for k, v in got.items()}
    mask = torch.ones(BATCH, dtype=torch.bool, device=dev)
    n_item = _sync_count(torch, lambda: mask.sum().item())
    check(n_item >= 1, f"the counter sees the synchronisation of .item() ({n_item})")
    n_fold = _sync_count(torch, lambda: fold(init(), one, mask))
    check(n_fold == 0, f"the fold makes no host synchronisation ({n_fold})")
    n_loop = _sync_count(torch, lambda: eng.run_resident(
        dt, batch_size=BATCH, collect=False, fold=fold, init=init()))
    n_bare = _sync_count(torch, lambda: eng.run_resident(dt, batch_size=BATCH,
                                                         collect=False))
    check(n_loop == n_bare, f"the folded loop makes {n_loop} host synchronisations over "
          f"{-(-dt.n_frames // BATCH)} batches, the loop without the fold {n_bare}")
    counts = dict(K.launch_counts)
    n_b = -(-dt.n_frames // BATCH)
    want = {"bai_breen_estimate": 5 * 4 * n_b, "bai_breen_refine": 5 * 4 * n_b,
            "pair_reduce": 5 * n_b}
    check(counts == want, f"phase 22 launches {counts}, predicted {want} (five passes of "
          f"{n_b} batches: 4 centres and one pair reduction a batch)")
    if n_bare:   # where the step synchronises (a pass cut at that point)
        site = _first_sync(torch, lambda: eng.run_resident(dt, batch_size=BATCH,
                                                           collect=False))
        say(f"  the step's first host synchronisation: {site}")

    # ---- host names on the 1M-atom System: no kernel ----------------------
    K.reset_launch_counts()
    t0 = time.perf_counter()
    box = system.simbox.to_lengths_vec()
    sphere = Sphere(np.asarray(box, np.float32) / 2, 3.0)
    g = Group.from_query_and_geometry("all", sphere, system)
    system.group_create_from_geometry("api22_geo", "all", sphere)
    check(np.array_equal(g.atoms.indices(), system.group_indices("api22_geo"))
          and 0 < g.get_n_atoms() < system.get_n_atoms(),
          f"Group.from_query_and_geometry equals group_create_from_geometry "
          f"({g.get_n_atoms()} atoms)")
    prot, mem = (Group.from_query(q, system) for q in ("Protein", "Membrane"))
    system.group_union("Protein", "Membrane", "api22_u")
    system.group_intersection("api22_geo", "Protein", "api22_i")
    check(np.array_equal(Group.union(prot, mem).atoms.indices(), system.group_indices("api22_u"))
          and np.array_equal(Group.intersection(g, prot).atoms.indices(),
                             system.group_indices("api22_i")),
          "Group.union and Group.intersection equal group_union and group_intersection")
    sample = np.sort(np.random.default_rng(22).choice(system.get_n_atoms(), API_SAMPLE,
                                                      replace=False))
    system.group_create_from_indices("api22_s", sample)
    pdb = os.path.join(K.BUILD_DIR, "api22.pdb")
    system.group_write_pdb("api22_s", pdb)
    with open(pdb) as fh:
        lines = [ln.rstrip("\n") for ln in fh if ln.startswith("ATOM")]
    check(lines == [format_pdb_atom_line(system, int(i)) for i in sample],
          f"format_pdb_atom_line equals the PDB writer over {API_SAMPLE} seeded atoms")
    for name in ("api22_geo", "api22_u", "api22_i", "api22_s"):
        system.group_remove(name)
    check(prelude.TrajectoryAnalysis is TrajectoryAnalysis
          and all(getattr(prelude, k) is getattr(root, k) for k in prelude.__all__),
          f"prelude holds the root's {len(prelude.__all__)} names")
    no_launches(dict(K.launch_counts), "the host names")
    say(f"  host names {time.perf_counter() - t0:.2f} s")
    return counts


WIRES = ("q16", "auto", "delta6", "delta")  # phase 23's passes, q16 the reference
WIRE_ROUNDS = 2  # rounds of phase 23's timed passes in turns (each: forwards, backwards)


def _wire_stats(torch, fbs, k, dev):
    """(bytes per atom-frame, escapes per frame (mean, max), rebuild ms per
    batch on the card) of one pass's FrameBatches; the rebuild timed on the
    second batch (a chained one) with CUDA events."""
    from groan_rs_tpu_torch.parallel.engine import rebuild_delta

    nbytes = sum(a.nbytes for fb in fbs for a in (fb.positions, fb.base_q, fb.shifts,
                                                  fb.esc_idx, fb.esc_val) if a is not None)
    frames = sum(len(fb) for fb in fbs)
    delta = [fb for fb in fbs if fb.wire in ("delta", "delta6")]
    esc = np.concatenate([(fb.esc_idx < k).sum(1) for fb in delta]) if delta else np.zeros(1)
    ms = None
    if delta:
        fb = delta[min(1, len(delta) - 1)]
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (fb.positions, fb.shifts, fb.esc_idx, fb.esc_val)]
        carry = torch.zeros((k, 3), dtype=torch.int32, device=dev)
        ms = cuda_ms(lambda: rebuild_delta(fb.wire, carry, *args, k), 5)
    return nbytes / (frames * k), (float(esc.mean()), int(esc.max())), ms


def _wire_pass(torch, runner, xtc, wire, dq, base, card):
    """Phase 23's passes of one wire (GROAN_WIRE already set): decode alone,
    two streamed passes, the resident load and both resident passes ->
    (stats dict, the resident window)."""
    from groan_rs_tpu_torch.parallel.engine import DeviceTrajectory

    t0 = time.perf_counter()
    fbs = list(runner._reader(xtc, BATCH).batches(wire=runner.wire, prefetch=False))
    t_dec = time.perf_counter() - t0
    shipped = [fb.wire for fb in fbs]
    if wire != "auto":
        check(set(shipped) == {wire}, f"GROAN_WIRE={wire}: every batch decodes as {wire}")
    bpa, esc, rebuild_ms = _wire_stats(torch, fbs, len(runner.sel), runner.engine.device)
    del fbs
    passes = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = runner.run(xtc, batch_size=BATCH)
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t0)
    eng = runner.engine
    clocks = {k: round(sum(v), 4) for k, v in eng.last_stage_seconds.items()}
    check(runner.last_route == "streamed" and eng.last_wires == shipped,
          f"{wire}: the streamed pass ships {shipped}")
    t0 = time.perf_counter()
    dt = runner.load_device(xtc, batch_size=BATCH)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check(eng.last_wires == shipped and isinstance(dt, DeviceTrajectory)
          and dt.kind == "q16" and dt.pos.dtype == torch.int16
          and (dq is None or torch.equal(dt.pos, dq.pos)),
          f"{wire}: load_device's integers equal the q16 load's ({t_load:.4f} s, {card})")
    res = {"streamed": out,
           "run_resident": eng.run_resident(dt, batch_size=BATCH),
           "run_resident_fused": eng.run_resident_fused(dt, batch_size=BATCH)}
    ref = out if base is None else base
    for label, got in res.items():
        e = max(float(np.abs(got[k].astype(np.float64) - ref[k]).max())
                for k in ("com", "dist", "rmsd", "mindist"))
        check(e <= 1e-6, f"{wire} {label} equals the q16 streamed pass (max diff {e:.1e})")
    return {"wires": shipped, "bytes": bpa, "escapes": esc, "rebuild_ms": rebuild_ms,
            "decode_s": t_dec, "passes": passes, "clocks": clocks, "load_s": t_load,
            "out": out}, dt


def wires_phase(torch, runner, xtc, system, card):
    """Phase 23: the main path on each wire of the ladder (streamed and
    resident), the one-shot pass and the frame-index cache -> the K1/K2/K3
    launches of the phase."""
    import tempfile

    from groan_rs_tpu_torch import TrajectoryAnalysis
    from groan_rs_tpu_torch.io import index_cache, native
    from groan_rs_tpu_torch.io.traj import XtcSource
    from groan_rs_tpu_torch.ops import kernels as K

    say(f"phase 23: the wires, the one-shot pass and the index cache, {N_ATOMS} atoms x "
        f"{N_FRAMES} frames, {len(runner.sel)} shipped ({card})")
    saved = {k: os.environ.pop(k, None) for k in ("GROAN_WIRE", "GROAN_ONESHOT_BYTES",
                                                  "GROAN_INDEX_CACHE_DIR")}
    K.reset_launch_counts()
    stats, dq, base = {}, None, None
    try:
        for wire in WIRES:
            if wire != "auto":
                os.environ["GROAN_WIRE"] = wire
            else:
                os.environ.pop("GROAN_WIRE", None)
            st, dt = _wire_pass(torch, runner, xtc, wire, dq, base, card)
            if wire == "q16":
                dq, base = dt, st["out"]
            else:
                del dt
            stats[wire] = st
            esc = st["escapes"]
            rb = "-" if st["rebuild_ms"] is None else (
                f"{st['rebuild_ms']:.4f} ms a batch ({st['rebuild_ms'] / BATCH:.4f} a frame)")
            say(f"  {wire}: batches {st['wires']}; {st['bytes']:.4f} B per atom-frame; "
                f"decode {st['decode_s']:.4f} s; rebuild {rb}; escapes a frame "
                f"{esc[0]:.1f} mean, {esc[1]} max; streamed {st['passes'][0]:.4f} s "
                f"(first), {st['passes'][1]:.4f} s (host clocks {st['clocks']}); "
                f"load_device {st['load_s']:.4f} s ({card})")
        # the wires' second passes again, in turns, forwards then backwards
        rounds = {w: [] for w in WIRES}
        for order in (WIRES, WIRES[::-1]) * WIRE_ROUNDS:
            for wire in order:
                os.environ.pop("GROAN_WIRE", None)
                if wire != "auto":
                    os.environ["GROAN_WIRE"] = wire
                t0 = time.perf_counter()
                runner.run(xtc, batch_size=BATCH)
                torch.cuda.synchronize()
                rounds[wire].append(time.perf_counter() - t0)
        say("  streamed passes in turns (median, min, max s): " + "; ".join(
            f"{w} {np.median(v):.4f}, {min(v):.4f}, {max(v):.4f}" for w, v in rounds.items())
            + f" ({card})")
        os.environ.pop("GROAN_WIRE", None)
        n_b = -(-N_FRAMES // BATCH)
        counts = dict(K.launch_counts)
        n_p = 4 + 2 * WIRE_ROUNDS  # passes a wire
        want = {"bai_breen_estimate": 4 * n_p * len(WIRES) * n_b,
                "bai_breen_refine": 4 * n_p * len(WIRES) * n_b,
                "pair_reduce": n_p * len(WIRES) * n_b}
        check(counts == want, f"the wire passes launch {counts}, predicted {want} ({n_p} "
              f"passes of {n_b} batches a wire: 4 centres and one pair reduction a batch)")
        check("delta6" in stats["auto"]["wires"], "auto ships delta6 on the bench XTC")

        # ---- the one-shot pass ------------------------------------------------
        pipe = (TrajectoryAnalysis(system, device=runner.engine.device)
                .add_com("Peptide", name="com").add_rmsd("Peptide", reference=system,
                                                         name="rmsd"))
        orunner = pipe.runner()
        est = N_FRAMES * len(orunner.sel) * 3 * 2
        K.reset_launch_counts()
        os.environ["GROAN_ONESHOT_BYTES"] = str(est)
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            one = orunner.run(xtc, batch_size=BATCH)
            times.append(time.perf_counter() - t0)
        check(orunner.last_route == "oneshot"
              and len(orunner.engine.last_stage_seconds["dispatch"]) == 1,
              f"the Peptide pass ({len(orunner.sel)} atoms, {est} B of q16 within a budget of "
              f"{est} B) runs one-shot in one step: {times[0]:.4f} s (first), {times[1]:.4f} s "
              f"({card})")
        os.environ["GROAN_ONESHOT_BYTES"] = str(est - 1)
        t0 = time.perf_counter()
        streamed = orunner.run(xtc, batch_size=BATCH)
        t_st = time.perf_counter() - t0
        check(orunner.last_route == "streamed"
              and len(orunner.engine.last_stage_seconds["dispatch"]) == n_b,
              f"one byte less streams it in {n_b} batches ({t_st:.4f} s, {card})")
        e = max(float(np.abs(one[k].astype(np.float64) - streamed[k]).max())
                for k in ("com", "rmsd"))
        check(e <= 1e-6 and np.array_equal(one["times"], streamed["times"]),
              f"the one-shot pass equals the streamed one (max diff {e:.1e})")
        ocounts = dict(K.launch_counts)
        owant = {"bai_breen_estimate": 2 * 2 + 2 * n_b, "bai_breen_refine": 2 * 2 + 2 * n_b,
                 "pair_reduce": 0}
        check(ocounts == owant, f"the one-shot passes launch {ocounts}, predicted {owant} "
              "(2 centres a step: two one-shot steps and one streamed pass)")
        say(f"  one-shot {times[1]:.4f} s against streamed {t_st:.4f} s ({card})")
        for k2, v in ocounts.items():
            counts[k2] += v

        # ---- the frame-index cache -------------------------------------------------
        os.environ.pop("GROAN_ONESHOT_BYTES", None)
        with tempfile.TemporaryDirectory(dir=K.BUILD_DIR) as d:
            os.environ["GROAN_INDEX_CACHE_DIR"] = d
            t0 = time.perf_counter()
            XtcSource(xtc, use_index_cache=False)
            t_plain = time.perf_counter() - t0
            t0 = time.perf_counter()
            first = XtcSource(xtc)
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
            again = XtcSource(xtc)
            t_cached = time.perf_counter() - t0
            check(os.path.exists(index_cache.index_path(xtc))
                  and os.path.dirname(index_cache.index_path(xtc)) == d
                  and np.array_equal(first.offsets, again.offsets)
                  and np.array_equal(again.offsets, native.xtc_scan(xtc)[0]),
                  f"the index cache: scan {t_plain:.4f} s, first open (scan + save) "
                  f"{t_first:.4f} s, cached open {t_cached:.4f} s "
                  f"({os.path.getsize(xtc) / 1e6:.0f} MB file, {len(first.offsets)} frames; "
                  f"{card})")
    finally:
        for k2, v in saved.items():
            if v is None:
                os.environ.pop(k2, None)
            else:
                os.environ[k2] = v
    return counts


def main_path_checks(out, frame0, coords, box, w, n_prot, what):
    """The main path's COM (the Protein's, masses `w`), its distance to the
    Membrane's centre and the fitted RMSD against `frame0`, each within
    2e-3 of float64 oracles over the frames of `coords` ([F, protein +
    membrane, 3])."""
    from groan_rs_tpu_torch import testing

    ref_com0 = testing.host_refined_center(frame0[:n_prot], box, w)
    box64 = np.asarray(box, np.float64)
    ref = np.mod(frame0[:n_prot] + (box64 / 2 - ref_com0), box64) - box64 / 2
    com_h, dist_h, rmsd_h = [], [], []
    for p in coords:
        ca = testing.host_refined_center(p[:n_prot], box, w)
        cb = testing.host_refined_center(p[n_prot:], box)
        d = ca - cb
        d -= box64 * np.round(d / box64)
        com_h.append(ca)
        dist_h.append(np.sqrt((d * d).sum()))
        rmsd_h.append(testing.host_kabsch_rmsd(ref, np.zeros(3), p[:n_prot], box, w))
    f = len(coords)
    errs = {"com": np.abs(out["com"][:f] - np.asarray(com_h)).max(),
            "dist": np.abs(out["dist"][:f] - np.asarray(dist_h)).max(),
            "rmsd": np.abs(out["rmsd"][:f] - np.asarray(rmsd_h)).max()}
    for k, e in errs.items():
        check(e < 2e-3, f"{what}{k} vs float64 oracle over {f} frames (max err {e:.3e})")


def main():
    import torch

    from groan_rs_tpu_torch import require_cuda

    # ---- 1. environment ---------------------------------------------
    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[dev.index or 0]
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(dev)}, python {sys.version.split()[0]}")

    from groan_rs_tpu_torch import convert, testing
    from groan_rs_tpu_torch.io import native
    from groan_rs_tpu_torch.models import TrajectoryAnalysis
    from groan_rs_tpu_torch.ops import kernels as K

    # the frame-index cache stays inside the checkout
    os.environ.setdefault("GROAN_INDEX_CACHE_DIR", os.path.join(K.BUILD_DIR, "index_cache"))

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
    out, passes, fetch_s = _streamed_passes(torch, runner, xtc)
    clocks = {k: round(sum(v), 4) for k, v in runner.engine.last_stage_seconds.items()}
    say(f"  streamed passes: {passes[0]:.4f} s (first), {passes[1]:.4f} s "
        f"= {N_FRAMES / passes[1]:.2f} frames/s; host clocks of the last "
        f"{clocks}, fetch {fetch_s:.4f} s; wires "
        f"{runner.engine.last_wires}")
    for k in ("com", "dist", "rmsd", "mindist"):
        v = out[k]
        check(v.shape[0] == N_FRAMES and bool(np.isfinite(v).all()),
              f"{k}: {v.shape} finite")

    n_prot, n_mem = testing.synthetic_sizes(N_ATOMS)
    w = state["mass"][:n_prot]
    coords, b9s, *_ = native.xtc_read_frames(xtc, offs[:PARITY_FRAMES], nat,
                                             stop_after=n_prot + n_mem)
    main_path_checks(out, c0[0], coords, box, w, n_prot, "")
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
    resident = {}
    for label, fn in (("run_resident_fused", runner.engine.run_resident_fused),
                      ("run_resident", runner.engine.run_resident)):
        res = resident[label] = fn(dt, batch_size=BATCH)
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
    tobs_counts, tobs_runner, tobs_dt, tri_site = triclinic_observables_phase(
        torch, dev, tpipe)
    t_phase = phase_seconds(9, t_phase)

    # ---- 10. from files to results ------------------------------------------
    file_counts, fsys = files_phase(torch, xtc, offs, nat, box, dev)
    t_phase = phase_seconds(10, t_phase)

    # ---- 11. hydrogen bonds and bond guessing --------------------------------
    hb_counts = hbonds_phase(torch, xtc, offs, nat, c0[0], box, fsys, dev)
    t_phase = phase_seconds(11, t_phase)

    # ---- 12. the System API ---------------------------------------------------
    api_counts = system_api_phase(torch, xtc, offs, nat, box, fsys, dev)
    t_phase = phase_seconds(12, t_phase)

    # ---- 13. the conformational analyses ------------------------------------
    struct_counts = structure_phase(torch, xtc, offs, nat, box, fsys, dev)
    t_phase = phase_seconds(13, t_phase)

    # ---- 14. the time-correlation and transport analyses ---------------------
    dyn_counts = dynamics_phase(torch, xtc, offs, nat, c0[0], box, dev)
    t_phase = phase_seconds(14, t_phase)

    # ---- 15. the membrane and interfacial-water analyses ----------------------
    mem_counts = membrane_phase(torch, xtc, offs, nat, c0[0], box, dev)
    t_phase = phase_seconds(15, t_phase)

    # ---- 16. the geometric and surface analyses ----------------------------------
    geo_counts = geometry_phase(torch, xtc, offs, nat, c0[0], box, dev, tri_site)
    t_phase = phase_seconds(16, t_phase)

    # ---- 17. scattering, free energy and system preparation ---------------------
    late_counts = late_models_phase(torch, xtc, offs, nat, c0[0], box, dev)
    t_phase = phase_seconds(17, t_phase)

    # ---- 18. the readers and writers -------------------------------------------------
    read_counts = readers_phase(torch, xtc, offs, nat, box, fsys, dev)
    del fsys
    t_phase = phase_seconds(18, t_phase)

    # ---- 19. multi-device ------------------------------------------------------------
    md_counts, md_sharded = multidevice_phase(
        torch, xtc, system, out, passes[1], orunner.system, tobs_runner.system, dev)
    t_phase = phase_seconds(19, t_phase)

    # ---- 20. the command line ------------------------------------------------------------
    cli_counts = cli_phase(torch, xtc)
    t_phase = phase_seconds(20, t_phase)

    # ---- 21. TPR files ------------------------------------------------------------------
    tpr_counts = tpr_phase(torch, xtc, offs, nat, c0[0], box, out)
    t_phase = phase_seconds(21, t_phase)

    # ---- 22. the rest of the public API ------------------------------------------------
    public_counts = api_phase(torch, runner, dt, xtc, system, resident["run_resident"])
    t_phase = phase_seconds(22, t_phase)

    # ---- 23. the wires, the one-shot pass and the index cache ------------------------
    wire_counts = wires_phase(torch, runner, xtc, system, card)
    t_phase = phase_seconds(23, t_phase)

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
         "launches": (counts[k] + file_counts[k] + hb_counts[k] + api_counts[k]
                      + struct_counts[k] + dyn_counts[k] + mem_counts[k] + geo_counts[k]
                      + late_counts[k] + read_counts[k] + md_counts[k] + cli_counts[k]
                      + tpr_counts[k] + public_counts[k] + wire_counts[k]),
         "max_abs_err": rec[k]["max_abs_err"],
         "ms": rec[k]["ms"], "plain_ms": rec[k]["plain_ms"],
         "bound_ms": rec[k]["bound"][0], "bound_by": rec[k]["bound"][1],
         "pct_of_bound": 100 * rec[k]["bound"][0] / rec[k]["ms"],
         "ms_l2_flushed": rec[k]["ms_l2_flushed"],
         "library_ms": None, "library_none": no_library[k],
         "shape": rec[k]["shape"], "observables_launches": obs_counts[k],
         "triclinic_launches": tri_counts[k] + tobs_counts[k],
         "main_path_launches": counts[k], "files_launches": file_counts[k],
         "hbonds_launches": hb_counts[k], "system_api_launches": api_counts[k],
         "structure_launches": struct_counts[k], "dynamics_launches": dyn_counts[k],
         "membrane_launches": mem_counts[k], "geometry_launches": geo_counts[k],
         "late_models_launches": late_counts[k], "readers_launches": read_counts[k],
         "multidevice_launches": md_counts[k], "sharded_launches": md_sharded[k],
         "cli_launches": cli_counts[k], "tpr_launches": tpr_counts[k],
         "public_api_launches": public_counts[k], "wires_launches": wire_counts[k]}
        for k in src]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
