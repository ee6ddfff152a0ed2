"""TrajectoryAnalysis: the composed per-frame analysis pass.

Port of `groan_rs_tpu/models/pipeline.py` (`_Idx` :38-75,
`_hydrogen_mask` :77-103, `TrajectoryAnalysis` :105-882, the velocity
observables :969-1027, `step_fn` / `runner` / `PipelineRunner`
:1057-1300, `run_many` :1488-1544):

    pipe = (TrajectoryAnalysis(system)
            .add_com("Protein")
            .add_distance("Protein", "Membrane", com=(True, False))
            .add_rmsd("Protein", reference=system)
            .add_gyration("Protein")
            .add_rdf("Peptide", "Membrane"))
    runner = pipe.runner()
    out = runner.run("traj.xtc", batch_size=12)   # dict of [F, ...] arrays
    dt = runner.load_device("traj.xtc")           # decode + ship once
    again = runner.run(dt)                        # device-resident re-run
    many = run_many([pipe, other], dt)            # one packed fetch
    cut = runner.run(["a.xtc", "b.xtc"], start_time=100.0, end_time=900.0,
                     step=2)                      # concatenated, range, stride
    kin = (TrajectoryAnalysis(system).add_kinetic_energy("Protein")
           .add_temperature("Water").run("traj.trr"))  # TRR velocities

Observables: center, com, distance, rmsd, min_distance, contacts,
gyration, density_map, density_profile, rdf, dipole, box_volume,
box_lengths, total_dipole, order, angles, dihedrals, principal and
in_shape; from velocities (TRR): kinetic_energy, temperature and custom
`add_velocity_step`s, plain torch in the step as they are plain jnp in
the JAX package (no kernel computes them).  Selections become slices
(contiguous ranges: views, no copy) or `index_select` gathers over the
shipped atom layout; masses, charges and the prepared RMSD reference
live on the device.  The centres
(center, com, distance, rmsd, gyration, dipole, principal) run on the
K1 + K2 kernels, min distance and contacts on K3 (above the pair
threshold).  Results are float32, except the int32 density-map and
in-shape counts (as in the JAX package) and the int64 contact counts.

`TrajectoryAnalysis(system, triclinic=True)` ships `[B, 3, 3]` box
matrices (`FrameEngine(box="matrix")`) and takes the JAX package's
triclinic branch of every observable: centres by `center_triclinic`,
displacements by the exact 27-image minimum image, min distance and
contacts by the triclinic pair kernel (`kernels.pair_reduce_triclinic`),
the RDF by the chunked triclinic pair path, volumes by |det|, box lengths
as row norms.  No triclinic step launches K1, K2 or K3.
`add_in_shape` refuses a triclinic pass, and `add_distance` any dimension
but XYZ, as in the JAX package.  With `triclinic=False` a triclinic
system's box is read as its diagonal, as in the JAX package.

Hydrogen bonds (`add_hbonds`, JAX `:884-967`): per-frame counts per
chain pair, by the cell scorer (host candidate ranks through the
engine's `on_batch`, scored on the device, streamed passes only) or the
dense counter (an in-step observable, computed once per step and split
into its keys; with `strict`, frames with guarded triples are re-read
and re-scored exactly on the host, streamed or resident).

On a mesh (`parallel.make_mesh`, `TrajectoryAnalysis(system,
mesh=...)`): a frames axis > 1 splits every batch over the devices of
the mesh's first column (a device other than the analysis's runs a
replica of its observables); an atoms axis > 1 streams the atoms-sharded
step of `sharded(mesh)` (`ops.sharded`).  A device-resident pass of a
frames-sharded runner, fused or not, runs on a single-device sibling
engine on the mesh's first device and equals the streamed sharded pass;
the atoms-sharded runner streams only.
"""

from __future__ import annotations

import functools
import itertools
import os
import time

import numpy as np
import torch

from ..backend import as_device, require_cuda
from ..core.dimension import Dimension
from ..core.simbox import simbox_check
from ..errors import GroupError, ParallelError, RMSDError, SimBoxError
from ..ops import center as center_ops
from ..ops import distances as distance_ops
from ..ops import geometry
from ..ops import pbc
from ..ops import rmsd as rmsd_ops
from ..utils import profiling as prof

__all__ = ["TrajectoryAnalysis", "PipelineRunner", "run_many"]

# add_hbonds(method="auto"): dense when every leg has at most this many
# donor x acceptor pairs, else cells (JAX `models/pipeline.py:925-931`)
_DENSE_MAX_PAIRS = 10**8


class _Idx:
    """Deferred atom-index set: raw full-system indices captured at
    configuration time, rewritten by `set_resolved` into the shipped layout.
    A contiguous ascending range becomes a slice — a view, which the
    centre kernels read in place — anything else an `index_select`."""

    __slots__ = ("raw", "j", "sl")

    def __init__(self, raw: np.ndarray):
        self.raw = np.asarray(raw)
        self.j = None
        self.sl = None

    def set_resolved(self, resolved: np.ndarray, device) -> None:
        resolved = np.asarray(resolved)
        n = resolved.shape[0]
        if n and resolved[-1] - resolved[0] == n - 1 and (
                n < 2 or (np.diff(resolved) == 1).all()):
            self.sl = (int(resolved[0]), int(resolved[0]) + n)
            self.j = None
        else:
            self.sl = None
            self.j = torch.as_tensor(resolved, dtype=torch.int64, device=device)

    def take(self, pos: torch.Tensor) -> torch.Tensor:
        if self.sl is not None:
            return pos[:, self.sl[0]:self.sl[1]]
        return pos.index_select(1, self.j)


def _hydrogen_mask(topo) -> np.ndarray:
    """Per-atom hydrogen flags: element symbol where assigned, else
    mass < 3.5 amu where present, else the first alphabetic character of
    the atom name (PDB-style hydrogens like '1HH1' lead with a digit).
    Each rule runs over the unique strings (`StrColumn.mask_predicate`),
    not per atom."""
    sym = topo.element_symbol
    has_sym = sym.mask_predicate(lambda c: bool(c.strip()))
    out = has_sym & sym.mask_predicate(lambda c: c.strip().upper() == "H")
    by_mass = ~has_sym & topo.has_mass
    out[by_mass] = topo.mass[by_mass] < 3.5
    rest = ~(has_sym | by_mass)
    if rest.any():
        name_is_h = topo.atomname.mask_predicate(
            lambda c: next((ch for ch in c if ch.isalpha()), "").upper() == "H")
        out[rest] = name_is_h[rest]
    return out


def _f32(x, device) -> torch.Tensor:
    """A float32 scalar tensor: dividing by it is a true division (CUDA
    divides by a Python scalar as a multiply by its reciprocal)."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def _histogram(bins, weights, n_bins: int, dtype) -> torch.Tensor:
    """Per-frame histograms of `[B, n]` bin indices in [0, n_bins) ->
    `[B, n_bins]`: `weights` (`[B, n]` or `[n]`) summed per bin over the
    flat int64 index `frame * n_bins + bin`.  Integer counts use
    `scatter_add_` (exact under atomics); float sums use
    `index_put_(accumulate=True)`, which sums each bin in a fixed order
    (sorted, on CUDA) where float atomics would not: the resident and
    streamed passes then agree bit for bit."""
    nb = bins.shape[0]
    flat = (bins.to(torch.int64)
            + torch.arange(nb, device=bins.device)[:, None] * n_bins).reshape(-1)
    src = weights.to(dtype).expand(bins.shape).reshape(-1)
    out = torch.zeros(nb * n_bins, dtype=dtype, device=bins.device)
    if dtype.is_floating_point:
        out.index_put_((flat,), src, accumulate=True)
    else:
        out.scatter_add_(0, flat, src)
    return out.reshape(nb, n_bins)


def _extract_reference_triclinic(reference, group: str, w: torch.Tensor):
    """The RMSD reference group unwrapped around its triclinic refined COM,
    and its weighted centroid (JAX `models/pipeline.py:321-328`), on the
    CPU -> (coords [n, 3], centroid [3])."""
    box = reference.get_box()
    if box is None:
        raise RMSDError("reference system has no simulation box",
                        code="InvalidSimBox")
    pos = torch.from_numpy(reference.positions[reference.group_indices(group)])
    return rmsd_ops.prepare_coords_triclinic(
        pos, torch.from_numpy(box.to_matrix()), weights=w.cpu())


def _cpu_com(reference, group: str, box) -> np.ndarray:
    """The group's refined COM by the K1 + K2 twins on CPU tensors, the
    float32 arithmetic the reference preparation has always used, whatever
    the reference System's device."""
    idx = reference.group_indices(group)
    if not reference.topology.has_mass[idx].all():
        bad = int(idx[~reference.topology.has_mass[idx]][0])
        raise GroupError(f"atom {bad} has no mass", code="InvalidMass")
    return center_ops.center(torch.from_numpy(reference.positions[idx]),
                             torch.from_numpy(box),
                             weights=torch.from_numpy(reference.topology.mass[idx])).numpy()


def _extract_reference(reference, group: str):
    """The RMSD reference group shifted so its COM sits at the box centre,
    then wrapped (`groan_rs_tpu/system/rmsd.py:18-40`, `_extract`), in the
    same float32 CPU arithmetic -> (coords [n, 3], box centre [3])."""
    try:
        box = simbox_check(reference.get_box()).to_lengths_vec()
    except SimBoxError as e:
        raise RMSDError(str(e), code="InvalidSimBox") from e
    try:
        idx = reference.group_indices(group)
        if idx.shape[0] == 0:
            raise RMSDError(f"group '{group}' is empty", code="EmptyGroup")
        com = _cpu_com(reference, group, box)
    except GroupError as e:
        code = {"NotFound": "NonexistentGroup"}.get(e.code, e.code)
        raise RMSDError(str(e), code=code) from e
    box_center = box * np.float32(0.5)
    pos = torch.from_numpy(reference.positions[idx])
    shifted = pbc.wrap(pos + torch.from_numpy(box_center - com),
                       torch.from_numpy(box))
    return shifted, torch.from_numpy(box_center)


class TrajectoryAnalysis:
    def __init__(self, system, *, device=None, triclinic: bool = False,
                 mesh=None):
        """`device`: where the pass runs ("cuda", "cuda:1" or "cpu"); the
        default is the mesh's first device, else the current CUDA card, and
        raises where there is none.  `triclinic=True`: per-frame `[B, 3, 3]`
        box matrices and the exact triclinic forms of every observable.
        `mesh` (`parallel.make_mesh`; also settable as `.mesh` later): a
        mesh with a frames axis > 1 splits each batch over its first
        column's devices, one with an atoms axis > 1 runs the atoms-sharded
        step of `sharded(mesh)` (JAX `models/pipeline.py:1082-1176`)."""
        from ..parallel.engine import check_mesh

        self.mesh = None if mesh is None else check_mesh(mesh)
        self.system = system
        self.triclinic = bool(triclinic)
        if device is not None:
            self.device = as_device(device)
        else:
            self.device = require_cuda() if mesh is None else self.mesh.devices[0, 0]
        # declarative observable records (the atoms-sharded compile) and
        # the add_* calls made (a replica on another device replays them)
        self._decls = []
        self._calls = []
        self._specs = []  # (name, fn(positions, boxes) -> tensor)
        self._vel_specs = []  # (name, fn(positions, velocities, boxes, mask))
        # (name, factory(sel) -> fn(positions, boxes) -> {name: tensor}):
        # several results of one computation (the dense hbond counter)
        self._multi_factories = []
        self._hbond_specs = []  # (name, HBondAnalysis): the cell scorer
        self._dense_strict = []  # (name, HBondAnalysis): guarded dense counts
        # name -> the dense counter of the last compiled step (its `calls`,
        # and on CUDA its `events`)
        self.dense_counters = {}
        self._handles: list[_Idx] = []

    # ------------------------------------------------------------- helpers
    def _declare(self, kind: str, name: str, **fields) -> None:
        """Record an observable's declaration (JAX `_decls`, `:117`)."""
        self._decls.append({"kind": kind, "name": name, **fields})

    def _replica(self, device) -> "TrajectoryAnalysis":
        """This analysis with every observable configured again on
        `device`: a frames shard on another device runs its step."""
        rep = TrajectoryAnalysis(self.system, device=device, triclinic=self.triclinic)
        for method, args, kwargs in self._calls:
            getattr(rep, method)(*args, **kwargs)
        return rep

    def _indices(self, group: str) -> np.ndarray:
        idx = self.system.group_indices(group)
        if idx.shape[0] == 0:
            raise GroupError(f"group '{group}' is empty", code="EmptyGroup")
        return idx

    def _register(self, raw: np.ndarray) -> _Idx:
        h = _Idx(raw)
        self._handles.append(h)
        return h

    def _resolve(self, sel: np.ndarray | None) -> None:
        """Rewrite every observable's indices into the shipped layout."""
        for h in self._handles:
            if sel is None:
                h.set_resolved(h.raw, self.device)
                continue
            pos = np.searchsorted(sel, h.raw)
            ok = (pos < len(sel)) & (sel[np.minimum(pos, len(sel) - 1)] == h.raw)
            if not ok.all():
                raise GroupError(
                    "trajectory selection does not cover all atoms the "
                    "configured observables touch", code="InvalidSelection")
            h.set_resolved(pos.astype(np.int64), self.device)

    def used_atoms(self) -> np.ndarray | None:
        """Union of all atoms the configured observables touch (sorted)."""
        if not self._handles:
            return None
        return np.unique(np.concatenate([h.raw for h in self._handles]))

    def _masses(self, group: str) -> torch.Tensor:
        idx = self._indices(group)
        if not self.system.topology.has_mass[idx].all():
            raise GroupError(f"group '{group}' has atoms without mass",
                             code="InvalidMass")
        return torch.as_tensor(self.system.topology.mass[idx], device=self.device)

    def _charges(self, group: str) -> torch.Tensor:
        idx = self._indices(group)
        if not self.system.topology.has_charge[idx].all():
            raise GroupError(f"group '{group}' has atoms without charge",
                             code="InvalidCharge")
        return torch.as_tensor(self.system.topology.charge[idx],
                               device=self.device)

    def _site_columns(self, sites, width: int, what: str):
        """Validate a `[K, width]` atom-index site table and register one
        deferred-index handle per column."""
        sites = np.asarray(sites, np.int64)
        if sites.ndim != 2 or sites.shape[1] != width or sites.shape[0] == 0:
            raise GroupError(
                f"{what} must be a non-empty [K, {width}] array of atom "
                "indices", code="InvalidSelection")
        n = int(self.system.get_n_atoms())
        if sites.min() < 0 or sites.max() >= n:
            raise GroupError(f"{what} reference atoms outside 0..{n - 1}",
                             code="AtomOutOfRange")
        return [self._register(sites[:, k]) for k in range(width)]

    def _to_center_fn(self, idx: _Idx, w=None):
        """(pos, boxes) -> the group's minimum-image displacements from
        its refined centre, [B, n, 3]."""
        c_fn = self._center_fn(idx, w)

        def fn(pos, boxes):
            return pbc.min_image_frames_any(
                idx.take(pos) - c_fn(pos, boxes)[:, None, :], boxes)
        return fn

    def _center_fn(self, idx: _Idx, w=None):
        if self.triclinic:
            def fn(pos, boxes):  # boxes [B, 3, 3]
                return center_ops.center_triclinic(idx.take(pos), boxes,
                                                   weights=w)
        else:
            def fn(pos, boxes):  # boxes [B, 3]
                return center_ops.center(idx.take(pos), boxes, weights=w)
        return fn

    # ------------------------------------------------------------- observables
    def add_center(self, group: str, name: str | None = None):
        """Refined Bai-Breen centre of geometry per frame -> [F, 3]."""
        idx = self._register(self._indices(group))
        self._declare("center", name or f"center_{group}", group=group, com=False)
        self._specs.append((name or f"center_{group}", self._center_fn(idx)))
        return self

    def add_com(self, group: str, name: str | None = None):
        """Refined centre of mass per frame -> [F, 3]."""
        idx = self._register(self._indices(group))
        self._declare("center", name or f"com_{group}", group=group, com=True)
        self._specs.append((name or f"com_{group}",
                            self._center_fn(idx, self._masses(group))))
        return self

    def add_distance(self, group1: str, group2: str,
                     dim: Dimension = Dimension.XYZ, com=False,
                     name: str | None = None):
        """Distance between group centres per frame -> [F] (analysis.rs:348).
        `com`: one bool for both groups or a (bool, bool) pair."""
        com1, com2 = (com, com) if isinstance(com, bool) else com
        c1 = self._center_fn(self._register(self._indices(group1)),
                             self._masses(group1) if com1 else None)
        c2 = self._center_fn(self._register(self._indices(group2)),
                             self._masses(group2) if com2 else None)
        dmask = dim.value
        if self.triclinic:
            if dim is not Dimension.XYZ:
                raise GroupError("triclinic distances support Dimension.XYZ "
                                 "only", code="InvalidDimension")

            def fn(pos, boxes):
                return pbc.distance_triclinic_frames(c1(pos, boxes),
                                                     c2(pos, boxes), boxes)
        else:
            def fn(pos, boxes):
                return pbc.distance(c1(pos, boxes), c2(pos, boxes), boxes,
                                    dmask)

        self._declare("distance", name or f"distance_{group1}_{group2}", g1=group1,
                      g2=group2, com1=com1, com2=com2, dim=dim)
        self._specs.append((name or f"distance_{group1}_{group2}", fn))
        return self

    def add_rmsd(self, group: str, reference, name: str | None = None):
        """Mass-weighted Kabsch RMSD vs a reference System per frame -> [F]
        (RMSDTrajRead::calc_rmsd, rmsd.rs:258)."""
        ref_idx = np.asarray(reference.group_indices(group))
        if ref_idx.shape[0] == 0:
            raise RMSDError(f"group '{group}' is empty", code="EmptyGroup")
        if not reference.topology.has_mass[ref_idx].all():
            bad = int(ref_idx[~reference.topology.has_mass[ref_idx]][0])
            raise RMSDError(f"atom {bad} has no mass", code="InvalidMass")
        w = torch.as_tensor(reference.topology.mass[ref_idx], device=self.device)
        tgt_idx = self._indices(group)
        if tgt_idx.shape[0] != ref_idx.shape[0]:
            raise RMSDError(
                f"group '{group}' has {ref_idx.shape[0]} atoms in reference "
                f"but {tgt_idx.shape[0]} in target", code="InconsistentGroup")
        idx = self._register(tgt_idx)
        if self.triclinic:
            ref_coords, ref_center = _extract_reference_triclinic(
                reference, group, w)
            frames_fn = rmsd_ops.rmsd_frames_triclinic
        else:
            ref_coords, ref_center = _extract_reference(reference, group)
            frames_fn = rmsd_ops.rmsd_frames
        refc = ref_coords.to(self.device)
        refctr = ref_center.to(self.device)

        def fn(pos, boxes):
            return frames_fn(refc, refctr, idx.take(pos), boxes, w)[1]

        self._declare("rmsd", name or f"rmsd_{group}", group=group, reference=reference)
        self._specs.append((name or f"rmsd_{group}", fn))
        return self

    def add_min_distance(self, group1: str, group2: str, name: str | None = None):
        """Minimum PBC distance between two selections per frame -> [F]
        (the tiled pair kernel K3 above the pair threshold; triclinic: the
        triclinic pair kernel)."""
        i1 = self._register(self._indices(group1))
        i2 = self._register(self._indices(group2))
        if self.triclinic:
            def fn(pos, boxes):
                return distance_ops.min_distance_triclinic(
                    i1.take(pos), i2.take(pos), boxes)
        else:
            def fn(pos, boxes):
                return distance_ops.min_distance(i1.take(pos), i2.take(pos),
                                                 boxes[:, None, :])

        self._declare("min_distance", name or f"mindist_{group1}_{group2}",
                      g1=group1, g2=group2)
        self._specs.append((name or f"mindist_{group1}_{group2}", fn))
        return self

    def add_contacts(self, group1: str, group2: str, cutoff: float,
                     name: str | None = None):
        """Contact count within `cutoff` per frame -> [F] int64."""
        i1 = self._register(self._indices(group1))
        i2 = self._register(self._indices(group2))
        if self.triclinic:
            def fn(pos, boxes):
                return distance_ops.contact_count_triclinic(
                    i1.take(pos), i2.take(pos), boxes, cutoff)
        else:
            def fn(pos, boxes):
                return distance_ops.contact_count(i1.take(pos), i2.take(pos),
                                                  boxes[:, None, :], cutoff)

        self._declare("contacts", name or f"contacts_{group1}_{group2}", g1=group1,
                      g2=group2, cutoff=float(cutoff))
        self._specs.append((name or f"contacts_{group1}_{group2}", fn))
        return self

    def add_gyration(self, group: str, name: str | None = None,
                     mass_weighted: bool = True, components: bool = False):
        """Radius of gyration per frame -> [F] nm: Rg = sqrt(sum_i w_i
        |r_i - c|^2 / sum_i w_i), minimum-image displacements to the
        group's refined centre c (mass-weighted by default; gmx gyrate).
        `components=True` -> [F, 4]: Rg plus the radii about x, y, z,
        sqrt(sum w (|d|^2 - d_a^2) / sum w)."""
        idx = self._register(self._indices(group))
        w = self._masses(group) if mass_weighted else None
        disp = self._to_center_fn(idx, w)

        def wmean(x):                              # [B, n] -> [B]
            if w is None:
                return x.mean(-1)
            return (w[None, :] * x).sum(-1) / w.sum()

        def fn(pos, boxes):
            d = disp(pos, boxes)
            r2 = (d * d).sum(-1)
            rg = torch.sqrt(wmean(r2))
            if not components:
                return rg
            about = torch.stack([torch.sqrt(wmean(r2 - d[..., a] ** 2))
                                 for a in range(3)], -1)
            return torch.cat([rg[:, None], about], -1)

        self._declare("gyration", name or f"gyration_{group}", group=group,
                      com=bool(mass_weighted), components=bool(components))
        self._specs.append((name or f"gyration_{group}", fn))
        return self

    def add_density_map(self, group: str, plane: str = "xy",
                        tile: float = 0.1, span=None, name: str | None = None):
        """Per-frame 2-D density map of a selection -> [F, nx, ny] int32
        counts (sum over axis 0 for the accumulated map; the reference's
        GridMap role, gridmap.rs:52).  plane: 'xy' | 'xz' | 'yz'; tile:
        bin size (nm); span: ((x0, x1), (y0, y1)), by default the system
        box at configuration time (not per frame).  Atoms outside the
        span are not counted."""
        axes = {"xy": (0, 1), "xz": (0, 2), "yz": (1, 2)}[plane]
        idx = self._register(self._indices(group))
        if span is None:
            box = np.asarray(self.system.box_lengths(), np.float64)
            span = ((0.0, float(box[axes[0]])), (0.0, float(box[axes[1]])))
        (x0, x1), (y0, y1) = span
        nx = max(1, int(round((x1 - x0) / tile)))
        ny = max(1, int(round((y1 - y0) / tile)))
        wx, wy = _f32(x1 - x0, self.device), _f32(y1 - y0, self.device)

        def fn(pos, boxes):
            g = idx.take(pos)                          # [B, n, 3]
            u = (g[..., axes[0]] - x0) / wx * nx
            v = (g[..., axes[1]] - y0) / wy * ny
            ui = torch.clamp(torch.floor(u).to(torch.int32), 0, nx - 1)
            vi = torch.clamp(torch.floor(v).to(torch.int32), 0, ny - 1)
            inside = (u >= 0) & (u < nx) & (v >= 0) & (v < ny)
            hist = _histogram(ui.to(torch.int64) * ny + vi, inside,
                              nx * ny, torch.int32)
            return hist.reshape(-1, nx, ny)

        self._declare("density", name or f"density_{group}_{plane}", group=group,
                      axes=axes, span=(x0, x1, y0, y1), nx=nx, ny=ny)
        self._specs.append((name or f"density_{group}_{plane}", fn))
        return self

    def add_density_profile(self, group: str, axis: str = "z",
                            n_bins: int = 100, mode: str = "number",
                            name: str | None = None):
        """Per-frame density profile along a box axis -> [F, n_bins]
        (gmx density): the axis is cut into `n_bins` slabs by fractional
        coordinate, so slabs follow the per-frame box; each atom's weight
        goes into its slab and the sums divide by the slab volume.  A
        triclinic pass takes the fractional coordinate from the inverse
        box matrix and the volume from |det|.

        mode: 'number' (atoms/nm^3), 'mass' (kg/m^3: amu/nm^3 times
        1.66053906660) or 'charge' (e/nm^3).  Slab centres sit at
        `(i + 0.5) / n_bins` in box fractions."""
        ax = {"x": 0, "y": 1, "z": 2}.get(axis)
        if ax is None:
            raise GroupError(f"unknown axis '{axis}' (use 'x'|'y'|'z')",
                             code="InvalidAxis")
        idx = self._register(self._indices(group))
        if mode == "number":
            w = torch.ones(int(idx.raw.shape[0]), device=self.device)
            scale = 1.0
        elif mode == "mass":
            w, scale = self._masses(group), 1.66053906660
        elif mode == "charge":
            w, scale = self._charges(group), 1.0
        else:
            raise GroupError(f"unknown density mode '{mode}'", code="InvalidMode")
        n_bins = int(n_bins)
        triclinic = self.triclinic

        def fn(pos, boxes):
            g = idx.take(pos)
            if triclinic:
                inv = pbc.box_inverse(boxes)                 # [B, 3, 3]
                frac = torch.einsum("bni,bi->bn", g, inv[:, :, ax])
                vol = pbc.box_volume(boxes)
            else:
                frac = g[..., ax] / boxes[:, None, ax]
                vol = torch.prod(boxes, -1)
            frac = frac - torch.floor(frac)
            bi = torch.clamp((frac * n_bins).to(torch.int32), 0, n_bins - 1)
            hist = _histogram(bi, w, n_bins, torch.float32)
            return hist * (n_bins * scale) / vol[:, None]

        self._declare("density_profile", name or f"profile_{group}_{axis}",
                      group=group, axis=ax, n_bins=n_bins, mode=mode,
                      scale=float(scale))
        self._specs.append((name or f"profile_{group}_{axis}", fn))
        return self

    def add_rdf(self, group1: str, group2: str, r_max: float = 2.0,
                n_bins: int = 200, name: str | None = None):
        """Radial distribution function g(r) between two selections per
        frame -> [F, n_bins]: the minimum-image pair-distance histogram
        (`ops.distances.pair_distance_histogram`, chunked over group1's
        atoms) over the ideal-gas shell counts.  Bin centres are
        `(np.arange(n_bins) + 0.5) * r_max / n_bins`."""
        i1 = self._register(self._indices(group1))
        i2 = self._register(self._indices(group2))
        same = group1 == group2
        n1, n2 = int(i1.raw.shape[0]), int(i2.raw.shape[0])
        r_max, n_bins = float(r_max), int(n_bins)

        def fn(pos, boxes):
            hist = distance_ops.pair_distance_histogram(
                i1.take(pos), i2.take(pos), boxes, r_max, n_bins,
                exclude_self=same)
            ideal = distance_ops.rdf_normalization(boxes, n1, n2, r_max, n_bins,
                                                   exclude_self=same)
            return hist.to(torch.float32) / ideal

        self._declare("rdf", name or f"rdf_{group1}_{group2}", g1=group1, g2=group2,
                      r_max=r_max, n_bins=n_bins, same=same)
        self._specs.append((name or f"rdf_{group1}_{group2}", fn))
        return self

    def add_dipole(self, group: str, name: str | None = None):
        """Per-frame dipole moment of a group -> [F, 3] e*nm (gmx
        dipoles): mu = sum_i q_i d_i, d_i the minimum-image displacement
        from the group's refined centre of mass.  1 e*nm = 48.032047
        Debye.  Needs charges and masses."""
        idx = self._register(self._indices(group))
        q = self._charges(group)
        disp = self._to_center_fn(idx, self._masses(group))

        def fn(pos, boxes):
            return (q[None, :, None] * disp(pos, boxes)).sum(1)

        self._declare("dipole", name or f"dipole_{group}", group=group)
        self._specs.append((name or f"dipole_{group}", fn))
        return self

    def add_box_volume(self, name: str = "box_volume"):
        """Per-frame box volume Lx*Ly*Lz (triclinic: |det|) -> [F] nm^3."""
        self._declare("volume", name)
        if self.triclinic:
            self._specs.append((name, lambda pos, boxes: pbc.box_volume(boxes)))
        else:
            self._specs.append((name, lambda pos, boxes: torch.prod(boxes, -1)))
        return self

    def add_box_lengths(self, name: str = "box_lengths"):
        """Per-frame box edge lengths -> [F, 3] nm.  The step returns the
        batch's box tensor itself; the engine copies results that share a
        staging buffer's storage before it refills the buffer.  A
        triclinic pass gives the norms of the three box vectors."""
        self._declare("box_lengths", name)
        if self.triclinic:
            self._specs.append(
                (name, lambda pos, boxes: torch.sqrt(pbc.norm2(boxes))))
        else:
            self._specs.append((name, lambda pos, boxes: boxes))
        return self

    def add_total_dipole(self, group: str, name: str | None = None):
        """Per-frame total dipole M of a group -> [F, 3] e*nm (gmx
        dipoles M_tot): the sum over molecules of sum_{i in m} q_i d_i,
        d_i the minimum-image displacement of atom i from its molecule's
        first group atom (summing q_i r_i over whole molecules for any
        molecule smaller than half the box).  Molecules come from the
        bond graph (`Topology.molecule_ids`).  Needs charges (and bonds:
        without them every atom is its own molecule)."""
        idx_np = self._indices(group)
        q = self._charges(group)
        mol = self.system.topology.molecule_ids()[idx_np]
        uniq, first = np.unique(mol, return_index=True)
        ref = torch.as_tensor(first[np.searchsorted(uniq, mol)],
                              dtype=torch.int64, device=self.device)
        idx = self._register(idx_np)

        def fn(pos, boxes):
            g = idx.take(pos)
            d = pbc.min_image_frames_any(g - g.index_select(1, ref), boxes)
            return (q[None, :, None] * d).sum(1)

        self._declare("total_dipole", name or f"total_dipole_{group}", group=group)
        self._specs.append((name or f"total_dipole_{group}", fn))
        return self

    def add_order(self, group: str, axis="z", name: str | None = None):
        """Per-frame bond order parameters -> [F, P] (gmx order): for
        every heavy atom -> bonded hydrogen bond of `group`, S = (3 cos^2
        theta - 1) / 2 with theta between the minimum-image bond vector
        and `axis` ('x' | 'y' | 'z' or a 3-vector, normalised here).

        Hydrogens as `_hydrogen_mask` finds them; the partner need not be
        in `group`.  Pairs are in file order of the heavy atom, then of
        the hydrogen; their global indices are kept in
        `self.order_pairs[name]`.  Needs bonds."""
        idxg = self._indices(group)
        topo = self.system.topology
        is_h = _hydrogen_mask(topo)
        offsets, flat = topo.bonds_csr()
        heavy = idxg[~is_h[idxg]]
        cnt = offsets[heavy + 1] - offsets[heavy]
        at = np.repeat(offsets[heavy] - np.cumsum(cnt) + cnt, cnt) \
            + np.arange(int(cnt.sum()))
        nbr = flat[at]
        keep = is_h[nbr]
        c_idx = np.repeat(heavy, cnt)[keep].astype(np.int64)
        h_idx = nbr[keep].astype(np.int64)
        if not c_idx.shape[0]:
            raise GroupError(
                f"group '{group}' has no heavy-atom-hydrogen bonds (does "
                "the topology carry bonds?)", code="NoBonds")
        ic = self._register(c_idx)
        ih = self._register(h_idx)
        if isinstance(axis, str):
            ax = {"x": 0, "y": 1, "z": 2}.get(axis)
            if ax is None:
                raise GroupError(f"unknown axis '{axis}' (use 'x'|'y'|'z' "
                                 "or a 3-vector)", code="InvalidAxis")
            nvec = np.zeros(3, np.float32)
            nvec[ax] = 1.0
        else:
            nvec = np.asarray(axis, np.float64)
            nrm = float(np.linalg.norm(nvec))
            if not nrm > 0:
                raise GroupError("axis vector must be non-zero",
                                 code="InvalidAxis")
            nvec = (nvec / nrm).astype(np.float32)
        n_t = torch.as_tensor(nvec, device=self.device)

        def fn(pos, boxes):
            d = pbc.min_image_frames_any(ih.take(pos) - ic.take(pos), boxes)
            cos2 = torch.square(d @ n_t) / (d * d).sum(-1)
            return 1.5 * cos2 - 0.5

        nm = name or f"order_{group}"
        if not hasattr(self, "order_pairs"):
            self.order_pairs = {}
        self.order_pairs[nm] = (c_idx, h_idx)
        self._declare("order", nm, group=group)
        self._specs.append((nm, fn))
        return self

    def add_angles(self, triplets, name: str | None = None):
        """Per-frame angles over `[K, 3]` atom-index triplets -> [F, K]
        degrees in [0, 180] (gmx angle); the middle column is the vertex.
        Minimum-image displacements, so PBC-split molecules are right."""
        ia, ib, ic = self._site_columns(triplets, 3, "triplets")
        triclinic = self.triclinic

        def fn(pos, boxes):
            return geometry.angles(ia.take(pos), ib.take(pos), ic.take(pos),
                                   boxes, triclinic=triclinic)

        self._declare("angles", name or "angles")
        self._specs.append((name or "angles", fn))
        return self

    def add_dihedrals(self, quadruplets, name: str | None = None):
        """Per-frame signed dihedrals over `[K, 4]` atom-index chains
        a-b-c-d -> [F, K] degrees in (-180, 180], IUPAC convention,
        trans = 180 (gmx angle -type dihedral)."""
        ia, ib, ic, id_ = self._site_columns(quadruplets, 4, "quadruplets")
        triclinic = self.triclinic

        def fn(pos, boxes):
            return geometry.dihedrals(ia.take(pos), ib.take(pos), ic.take(pos),
                                      id_.take(pos), boxes, triclinic=triclinic)

        self._declare("dihedrals", name or "dihedrals")
        self._specs.append((name or "dihedrals", fn))
        return self

    def add_principal(self, group: str, name: str | None = None,
                      mass_weighted: bool = True):
        """Per-frame principal moments of inertia -> [F, 3] ascending (gmx
        principal), in amu nm^2 (nm^2 unweighted): the eigenvalues of
        I = sum_i w_i (|d_i|^2 E - d_i d_i^T), d_i the minimum-image
        displacements from the group's refined centre.

        I is built from the 3x3 sums S = sum w d d^T (one batched matmul,
        TF32 off): I_aa = S_bb + S_cc, I_ab = -S_ab, so no [B, n, 3, 3]
        tensor exists.  `torch.linalg.eigvalsh`, ascending."""
        idx = self._register(self._indices(group))
        w = (self._masses(group) if mass_weighted
             else torch.ones(int(idx.raw.shape[0]), device=self.device))
        disp = self._to_center_fn(idx, w)

        def fn(pos, boxes):
            d = disp(pos, boxes)
            s = torch.matmul((d * w[None, :, None]).transpose(1, 2), d)
            diag = s.diagonal(dim1=1, dim2=2)
            moments = torch.stack([diag[:, 1] + diag[:, 2],
                                   diag[:, 0] + diag[:, 2],
                                   diag[:, 0] + diag[:, 1]], -1)
            inertia = torch.diag_embed(moments) - (s - torch.diag_embed(diag))
            if prof.TRACING:   # the solver's error check waits for the device
                prof.count("host_sync", "principal.eigvalsh")
            return torch.linalg.eigvalsh(inertia)

        self._declare("principal", name or f"principal_{group}")
        self._specs.append((name or f"principal_{group}", fn))
        return self

    def add_in_shape(self, group: str, shape, name: str | None = None):
        """Per-frame count of `group` atoms inside a `core.shapes` Sphere,
        Rectangular or Cylinder -> [F] int32, with the shapes' PBC
        semantics (`ops.geometry.inside_shape`).  Any other shape raises
        ShapeError here, at configuration time; a triclinic pass raises
        GroupError (the shapes' PBC semantics are orthorhombic)."""
        if self.triclinic:
            raise GroupError(
                "shape observables use the shapes' orthorhombic PBC "
                "semantics; triclinic pipelines are not supported",
                code="InvalidSimBox")
        geometry.inside_shape(shape, torch.zeros(1, 1, 3), torch.ones(1, 3))
        idx = self._register(self._indices(group))

        def fn(pos, boxes):
            return geometry.inside_shape(shape, idx.take(pos), boxes).sum(
                1, dtype=torch.int32)

        self._declare("in_shape", name or f"in_shape_{group}")
        self._specs.append((name or f"in_shape_{group}", fn))
        return self

    def add_hbonds(self, chains, pairs, max_distance: float = 0.35,
                   min_angle: float = 120.0, name: str | None = None,
                   method: str = "auto", strict: bool = True):
        """Per-frame hydrogen-bond counts per chain pair (reference:
        HBondTrajRead::hbonds_analyze, hbonds.rs:457) -> one key per pair,
        `{name}_{c1}_{c2}`: [F] int64.

        `method`:
        - "cells": the host's cell walk gives candidate pair ranks per
          batch, the device scores them, guarded triples are re-scored on
          the host: counts equal `System.hbonds_analyze` exactly.  Streamed
          passes only (a resident window raises ParallelError).
        - "dense": every donor x acceptor pair in the step, tiled over
          donors (`system.hbonds.make_dense_counter`).  With `strict`
          (default) the step also counts guarded triples per frame, and
          every frame with one is re-read (streamed) or fetched from the
          window (resident) and re-scored exactly; `strict=False` keeps
          the device's decisions at the boundary.
        - "auto": "dense" when every leg has at most 10^8 donor x acceptor
          pairs, else "cells"."""
        from ..errors import HBondError
        from ..system.hbonds import HBondAnalysis

        if self.triclinic:
            raise GroupError("hydrogen bonds take orthogonal boxes; triclinic "
                             "pipelines are not supported", code="InvalidSimBox")
        analysis = HBondAnalysis(self.system, chains, pairs, max_distance,
                                 min_angle, device=self.device)
        touched = np.unique(np.concatenate(
            [np.concatenate([c.acceptors, c.donors, c.h_idx]) for c in analysis.chains]))
        self._register(touched)  # ship="auto" must cover the chains
        nm = name or "hbonds"
        self._declare("hbonds", nm)
        if method == "auto":
            worst = max((acc.acceptors.shape[0] * don.donors.shape[0]
                         for _, acc, don, _, _ in analysis._tables().legs), default=0)
            method = "dense" if worst <= _DENSE_MAX_PAIRS else "cells"
        if method == "cells":
            self._hbond_specs.append((nm, analysis))
            return self
        if method != "dense":
            raise HBondError(f"unknown hbond method '{method}' (auto, cells or dense)",
                             code="InvalidMethod")
        keys = [f"{nm}_{c1}_{c2}" for c1, c2 in analysis.pairs]

        def factory(sel):
            from ..system.hbonds import make_dense_counter

            count = make_dense_counter(self._remapped(analysis, sel), with_guard=strict)
            self.dense_counters[nm] = count

            def fn(pos, boxes):  # one evaluation per step, split into keys
                res = count(pos, boxes)
                counts = res[0] if strict else res
                out = {k: counts[:, p] for p, k in enumerate(keys)}
                if strict:
                    out[f"__guard__{nm}"] = res[1]
                return out
            return fn

        self._multi_factories.append((nm, factory))
        if strict:
            self._dense_strict.append((nm, analysis))
        return self

    def _remapped(self, analysis, sel):
        """`analysis` in the shipped layout `sel` (None: the full system)."""
        from ..system.hbonds import remap_analysis

        if sel is None:
            return analysis
        lut = np.full(self.system.get_n_atoms(), -1, np.int64)
        lut[sel] = np.arange(sel.shape[0])
        return remap_analysis(analysis, lut)

    def add_kinetic_energy(self, group: str, name: str | None = None):
        """Per-frame kinetic energy of a group -> [F] kJ/mol from TRR
        velocities: KE = 1/2 sum_i m_i |v_i|^2 (needs masses and a
        velocity-carrying trajectory)."""
        idx = self._register(self._indices(group))
        w = self._masses(group)

        def fn(pos, vel, boxes, mask):
            v = idx.take(vel)                                  # [B, n, 3]
            return 0.5 * (w[None, :] * (v * v).sum(-1)).sum(-1)

        self._declare("kinetic", name or f"kinetic_{group}", group=group)
        self._vel_specs.append((name or f"kinetic_{group}", fn))
        return self

    def add_temperature(self, group: str, name: str | None = None,
                        ndf: float | None = None):
        """Per-frame kinetic temperature of a group -> [F] Kelvin:
        T = 2 KE / (ndf kB), kB = 0.008314462618 kJ/(mol K); `ndf`
        defaults to 3N (no constraint correction)."""
        idx = self._register(self._indices(group))
        w = self._masses(group)
        dof = float(ndf) if ndf is not None else 3.0 * int(idx.raw.shape[0])
        denom = _f32(dof * 0.008314462618, self.device)

        def fn(pos, vel, boxes, mask):
            v = idx.take(vel)
            ke = 0.5 * (w[None, :] * (v * v).sum(-1)).sum(-1)
            return 2.0 * ke / denom

        self._declare("temperature", name or f"temperature_{group}", group=group)
        self._vel_specs.append((name or f"temperature_{group}", fn))
        return self

    def add_velocity_step(self, name: str, fn, touches: str | None = None):
        """A custom velocity observable: `fn(positions [B, K, 3],
        velocities [B, K, 3], boxes, frame_mask) -> [B, ...]` runs in the
        step beside the built-ins, on the shipped layout.  `touches` (a
        group name) declares the atoms `fn` reads, so that `ship="auto"`
        ships them; None ships every atom."""
        if touches is not None:
            self._register(self._indices(touches))
        else:
            self._register(np.arange(self.system.get_n_atoms()))
        self._declare("velocity_step", name)
        self._vel_specs.append((name, fn))
        return self

    @property
    def needs_velocities(self) -> bool:
        return bool(self._vel_specs)

    # ------------------------------------------------------------- compile
    def sharded(self, mesh):
        """Compile the configured observables into one step over a
        `(frames, atoms)` mesh (`ops.sharded`; JAX `:1034-1055`) -> `(step,
        params, n_pad)`, called as `step(positions [B, n_pad, 3], boxes,
        frame_mask, inv_prec, *params)`; int16 positions (the q16 wire)
        are dequantized per shard with `inv_prec`."""
        from ..ops.sharded import build_sharded_step, compile_decl
        from ..parallel.engine import check_mesh

        check_mesh(mesh)
        if not self._decls:
            raise ParallelError("no observables configured")
        specs = [compile_decl(d, self.system, triclinic=self.triclinic)
                 for d in self._decls]
        return build_sharded_step(mesh, specs, self.system.get_n_atoms(),
                                  triclinic=self.triclinic)

    def _mesh_step(self, sel, mesh):
        """The composed step for a frames-sharded mesh: each shard's
        inputs go to the step configured on their device (this analysis's
        own, or a replica's on another device)."""
        step = self.step_fn(sel)
        devs = [d for d in dict.fromkeys(mesh.devices[:, 0]) if d != self.device]
        if not devs:
            return step
        by_dev = {self.device: step}
        by_dev.update((d, self._replica(d).step_fn(sel)) for d in devs)

        def on_device(positions, boxes, frame_mask, velocities=None):
            return by_dev[positions.device](positions, boxes, frame_mask, velocities)

        return on_device

    def step_fn(self, sel: np.ndarray | None = None):
        """The composed step `(positions [B, K, 3], boxes [B, 3] or
        [B, 3, 3], mask[, velocities [B, K, 3]]) -> dict` (velocities when
        a velocity observable is configured); `sel` (sorted atom indices)
        declares the shipped layout — positions[:, k] is atom sel[k];
        None = the full system."""
        self._resolve(sel)
        specs = list(self._specs)
        multi = [(name, factory(sel)) for name, factory in self._multi_factories]
        vel_specs = list(self._vel_specs)

        def step(positions, boxes, frame_mask, velocities=None):
            if prof.TRACING:
                return traced(positions, boxes, frame_mask, velocities)
            out = {name: fn(positions, boxes) for name, fn in specs}
            for _, fn in multi:
                out.update(fn(positions, boxes))
            for name, fn in vel_specs:
                out[name] = fn(positions, velocities, boxes, frame_mask)
            return out

        def traced(positions, boxes, frame_mask, velocities):
            """The same step, each observable's call in a span
            `dispatch/<name>` (`utils/profiling.py`)."""
            out = {}
            for name, fn in specs:
                with prof.span("dispatch/" + name):
                    out[name] = fn(positions, boxes)
            for name, fn in multi:
                with prof.span("dispatch/" + name):
                    out.update(fn(positions, boxes))
            for name, fn in vel_specs:
                with prof.span("dispatch/" + name):
                    out[name] = fn(positions, velocities, boxes, frame_mask)
            return out

        return step

    def runner(self, *, group: str | None = None, wire: str = "auto",
               ship: str = "auto", velocities: bool = False) -> "PipelineRunner":
        """Compile the configured observables into a reusable runner.

        `ship="auto"` decodes only up to the last atom any observable
        touches and ships only the union of touched atoms; `ship="all"`
        ships every atom; `group` ships that group's atoms (it must cover
        every atom the observables touch).  `wire` (JAX `:1082-1176`):
        "auto" lets the reader ship each chunk on the smallest wire it
        fits (delta6 -> delta -> q16 -> f32, `io/traj.py`); "delta6",
        "delta", "q16" and "f32" pin one (each decodes on the device
        bit-identically to the float decode; a TRR trajectory ships f32
        whatever the wire).  "auto" becomes "q16" on a frames-sharded
        mesh, with velocity channels and with the cell hydrogen-bond
        scorer (it bins absolute host coordinates; an explicit delta wire
        raises HBondError there); an explicit delta wire with velocities
        or on a frames-sharded mesh raises the engine's ParallelError when
        the pass runs.  Velocities
        ride beside the positions when a velocity observable is
        configured or `velocities=True` (a resident window that later
        velocity passes read).

        On a mesh (`self.mesh`) with an atoms axis > 1 the runner streams
        the atoms-sharded step of `sharded(mesh)` over the full atom layout
        on the q16 (or f32) wire, whatever delta wire was asked for:
        `group=`, hydrogen bonds and velocities are refused there, as in
        the JAX package."""
        from ..parallel.engine import FrameEngine, check_mesh

        mesh = None if self.mesh is None else check_mesh(self.mesh)
        if mesh is not None and mesh.shape["atoms"] > 1:
            if group is not None:
                raise GroupError(
                    "the atoms-sharded step evaluates masks over the full "
                    "atom layout; group reads are not supported",
                    code="InvalidSelection")
            if any(d["kind"] == "hbonds" for d in self._decls):
                raise GroupError(
                    "hbond observables have no atoms-sharded formulation",
                    code="InvalidSelection")
            if self._vel_specs or velocities:
                raise ParallelError(
                    "velocity observables have no atoms-sharded "
                    "formulation yet; use a frames-only mesh")
            engine = FrameEngine(None, mesh=mesh, spec=self.sharded(mesh),
                                 box="matrix" if self.triclinic else "lengths")
            return PipelineRunner(self.system, engine, None,
                                  "f32" if wire == "f32" else "q16")
        if self._hbond_specs and wire in ("delta", "delta6"):
            from ..errors import HBondError

            raise HBondError("hbond observables need absolute per-frame "
                             "coordinates; use wire='q16' or 'f32'", code="InvalidWire")
        # the delta wires rebuild frames in order on one device, velocities
        # ride the q16/f32 wires, the cell scorer bins absolute coordinates
        if wire == "auto" and ((mesh is not None and mesh.shape["frames"] > 1)
                               or self._vel_specs or velocities or self._hbond_specs):
            wire = "q16"
        if group is not None:
            sel = np.asarray(self.system.group_indices(group))
        elif ship == "auto":
            sel = self.used_atoms()
        elif ship == "all":
            sel = None
        else:
            raise GroupError(f"unknown ship mode '{ship}'", code="InvalidSelection")
        if sel is not None and sel.shape[0] >= self.system.get_n_atoms():
            sel = None
        aux = ("vel",) if (self._vel_specs or velocities) else ()
        step = self.step_fn(sel) if mesh is None else self._mesh_step(sel, mesh)
        engine = FrameEngine(step, self.device if mesh is None else None, mesh=mesh,
                             aux=aux, box="matrix" if self.triclinic else "lengths")
        # hbond analyses in the shipped layout (the cell scorer bins and
        # the strict re-score reads the shipped coordinates)
        return PipelineRunner(
            self.system, engine, sel, wire,
            hbond_specs=[(nm, self._remapped(a, sel)) for nm, a in self._hbond_specs],
            dense_strict=[(nm, self._remapped(a, sel)) for nm, a in self._dense_strict])

    def run(self, filename, *, group: str | None = None, batch_size: int = 32,
            start_time=None, end_time=None, step=None, progress=None,
            wire: str = "auto", ship: str = "auto"):
        """One-shot form of `runner(...).run(filename, ...)`."""
        return self.runner(group=group, wire=wire, ship=ship).run(
            filename, batch_size=batch_size, start_time=start_time,
            end_time=end_time, step=step, progress=progress)


def _recorded(method):
    """Wrap an `add_*` method so that its call is kept for `_replica`."""
    @functools.wraps(method)
    def add(self, *args, **kwargs):
        out = method(self, *args, **kwargs)
        self._calls.append((method.__name__, args, kwargs))
        return out
    return add


for _name in [n for n in vars(TrajectoryAnalysis) if n.startswith("add_")]:
    setattr(TrajectoryAnalysis, _name, _recorded(getattr(TrajectoryAnalysis, _name)))
del _name


class PipelineRunner:
    """A compiled TrajectoryAnalysis pass, reusable across files/calls."""

    def __init__(self, system, engine, sel, wire, hbond_specs=(), dense_strict=()):
        """`hbond_specs` / `dense_strict`: (name, HBondAnalysis in the
        shipped layout) of the cell scorer and of the strict dense
        counters."""
        self.system = system
        self.engine = engine
        self.sel = sel
        self.wire = wire
        self.hbond_specs = list(hbond_specs)
        self.dense_strict = list(dense_strict)
        # of the last pass: name -> guarded triples per frame of each strict
        # dense counter, and the seconds its flagged frames took to re-score
        self.last_guards = {}
        self.last_rescore_seconds = {}
        self.last_route = None  # "oneshot" or "streamed": the last streamed-file pass
        self._resident_engine = None

    def _engine_1dev(self):
        """The engine of device-resident passes (JAX `:1202-1224`): a
        window lives on one device, so a frames-sharded runner gets a
        sibling engine with the same step on the mesh's first device; the
        atoms-sharded runner streams only."""
        eng = self.engine
        if eng._spec is not None:
            raise ParallelError(
                "device-resident passes need the per-batch step; the "
                "atoms-sharded spec runner streams instead")
        if eng.n_shards == 1:
            return eng
        if self._resident_engine is None:
            from ..parallel.engine import FrameEngine

            self._resident_engine = FrameEngine(eng._user_step, eng.device,
                                                box=eng.box_form, aux=eng.aux)
        return self._resident_engine

    def _reader(self, filename, batch_size, start_time=None, end_time=None,
                step=None, progress=None):
        """The batched reader of one file, or of a list of files
        concatenated with boundary time dedup, with the reader options."""
        from ..io.traj import cat_iter, traj_iter

        make = cat_iter if isinstance(filename, (list, tuple)) else traj_iter
        with prof.span("open"):
            reader = make(self.system, filename, indices=self.sel,
                          batch_size=batch_size, start_time=start_time,
                          end_time=end_time, step=step,
                          velocities="vel" in self.engine.aux)
        if progress is not None:
            reader.print_progress(progress)
        return reader

    def _check_layout(self, dt) -> None:
        """Refuse a DeviceTrajectory shipped with another box form, or one
        that `load_device` stamped with another atom layout: a window of
        the same width would raise no shape error and read the wrong
        atoms (or read lengths as matrices).  A window from
        `FrameEngine.materialize` carries no stamp; its caller owns the
        layout (JAX `_check_resident_layout`, `pipeline.py:1469-1486`)."""
        self.engine.check_box_form(dt)
        if not dt.sel_known:
            return
        if (dt.sel is None) != (self.sel is None) or (
                dt.sel is not None and not np.array_equal(dt.sel, self.sel)):
            raise ParallelError(
                "this DeviceTrajectory holds another atom layout than the "
                "runner ships; load it through this runner, or build every "
                "runner with ship='all' so they share one layout")

    def load_device(self, filename, *, batch_size: int = 32, start_time=None,
                    end_time=None, step=None, progress=None):
        """Decode and ship a trajectory once into device memory (one file
        or a list of files, with the reader options of `run`); pass the
        returned `DeviceTrajectory` to `run` to re-analyse it."""
        with prof.span("load_device", batch_size=batch_size):
            reader = self._reader(filename, batch_size, start_time, end_time, step,
                                  progress)
            dt = self._engine_1dev().materialize(reader.batches(wire=self.wire))
        # stamp the shipped-atom layout: a runner compiled for another
        # selection of the same width would read the wrong atoms
        dt.sel = None if self.sel is None else np.asarray(self.sel)
        dt.sel_known = True
        return dt

    def run(self, filename, *, batch_size: int = 32, start_time=None,
            end_time=None, step=None, progress=None, profiler=None):
        """Run over one XTC or TRR file, a list of files concatenated with
        boundary time dedup (reference: traj_cat.rs), or a
        `DeviceTrajectory` from `load_device` (device-resident
        re-analysis: no I/O, no copy).  `start_time` / `end_time` (ps)
        keep a time range, `step` every n-th frame, `progress` (a
        `progress.ProgressPrinter`) reports the frames read, `profiler`
        (a `utils.profiling.PipelineProfiler`) times each streamed batch's
        stages, synchronising each batch (a resident pass ignores it).

        A pass whose wire fits `GROAN_ONESHOT_BYTES` runs as one batch
        (`FrameEngine.run_oneshot`; `last_route` says which ran).

        Returns a dict of `[F, ...]` numpy arrays plus 'times' and 'steps'.
        A resident window of 4 or more batches runs as fixed-shape slabs
        (`run_resident_fused`), a shorter one batch by batch
        (`run_resident`), as in the JAX runner; GROAN_RESIDENT_FUSED=1 or
        0 forces either.

        With `utils.profiling.tracing` on, the call is a span `pass` (its
        route: "resident_fused", "resident", "oneshot" or "streamed")."""
        args = (filename, batch_size, start_time, end_time, step, progress, profiler)
        if not prof.TRACING:
            return self._run(*args)[0]
        with prof.span("pass", batch_size=batch_size) as sp:
            out, route = self._run(*args)
            if sp is not None:
                sp.attrs.update(route=route, frames=len(out["times"]))
        return out

    def _run(self, filename, batch_size, start_time, end_time, step, progress,
             profiler):
        """`run` -> (its results, the route that ran them)."""
        from ..parallel.engine import DeviceTrajectory

        if isinstance(filename, DeviceTrajectory):
            dt = filename
            self._refuse_cells()
            self._check_layout(dt)
            fused = os.environ.get("GROAN_RESIDENT_FUSED", "auto")
            eng = self._engine_1dev()
            if fused == "1" or (fused == "auto"
                                and -(-dt.n_frames // max(1, batch_size)) >= 4):
                route, out = "resident_fused", eng.run_resident_fused(dt, batch_size=batch_size)
            else:
                route, out = "resident", eng.run_resident(dt, batch_size=batch_size)
            self._finish_dense_guards(out, lambda ids: self._window_frames(dt, ids))
            out["times"] = dt.times
            out["steps"] = dt.steps
            return out, route
        reader = self._reader(filename, batch_size, start_time, end_time, step,
                              progress)
        for _, analysis in self.hbond_specs:
            analysis.batch_stats = []
        hb_counts = {nm: [] for nm, _ in self.hbond_specs}
        hb_batch = itertools.count()  # the `hbond` span's batch number

        def on_batch(fb):
            sp = (prof.begin("hbond", batch=next(hb_batch), frames=len(fb))
                  if prof.TRACING else None)
            pos, boxes = fb.positions, fb.box_lengths()
            q_pos = inv = None
            if fb.wire == "q16":
                # ship the raw ints; dequantize a host copy for candidate
                # binning and the exact re-score (the device's arithmetic)
                q_pos = pos
                inv = np.float32(1.0) / np.asarray(fb.precisions, np.float32)
                pos = pos.astype(np.float32) * inv[:, None, None]
            for nm, analysis in self.hbond_specs:
                hb_counts[nm].append(analysis.analyze_batch(
                    pos, boxes, counts_only=True, q_positions=q_pos, inv_prec=inv))
            prof.end(sp)

        out = self._oneshot(reader, on_batch) if profiler is None else None
        self.last_route = "streamed" if out is None else "oneshot"
        if out is None:
            out = self.engine.run(reader.batches(wire=self.wire),
                                  on_batch=on_batch if self.hbond_specs else None,
                                  profiler=profiler)
        for nm, analysis in self.hbond_specs:
            for pair in analysis.pairs:
                out[f"{nm}_{pair[0]}_{pair[1]}"] = (
                    np.concatenate([c[pair] for c in hb_counts[nm]])
                    if hb_counts[nm] else np.zeros(0, np.int64))
        frames = reader.selected_frames()
        self._finish_dense_guards(
            out, lambda ids: self._file_frames(reader, frames[ids]))
        out["times"] = reader.times
        out["steps"] = reader.steps
        return out, self.last_route

    def _oneshot(self, reader, on_batch):
        """The pass as one batch through `FrameEngine.run_oneshot` when it
        fits `GROAN_ONESHOT_BYTES` (6,000,000 by default) on the q16 or
        f32 wire (`GROAN_WIRE`, else the runner's, "auto" read as q16), on
        a single-shard per-batch engine (JAX `:1322-1346`) -> its results,
        or None to stream.  A delta wire streams.  The pass runs on the
        runner's device: there is no automatic CPU route."""
        eng = self.engine
        with prof.span("open"):
            budget = int(os.environ.get("GROAN_ONESHOT_BYTES", 6_000_000))
            wire = os.environ.get("GROAN_WIRE", "q16" if self.wire == "auto" else self.wire)
            if eng._spec is not None or eng.n_shards != 1 or wire not in ("q16", "f32"):
                return None
            n_f = reader.n_selected()
            n_ship = len(self.sel) if self.sel is not None else self.system.get_n_atoms()
            est = n_f * n_ship * 3 * (4 if wire == "f32" else 2)
            if not 0 < est <= budget:
                return None
        fbs = list(reader.batches(batch_size=n_f, wire=wire, prefetch=False))
        if len(fbs) != 1:
            return None
        out = eng.run_oneshot(fbs[0])
        if self.hbond_specs:
            on_batch(fbs[0])
        return out

    # ------------------------------------------------------------ hbonds
    def _refuse_cells(self) -> None:
        if self.hbond_specs:
            raise ParallelError(
                "hbond analyses with method='cells' generate candidates on the "
                "host from each streamed batch; run them with a filename")

    @staticmethod
    def _file_frames(reader, frame_ids):
        """(float32 positions, box lengths) of frames read again from the
        file, in the shipped layout."""
        fb = reader.read_frames(frame_ids)
        return np.asarray(fb.positions, np.float32), fb.box_lengths()

    @staticmethod
    def _window_frames(dt, ids):
        """(float32 positions, box lengths) of frames of a resident window,
        dequantized on the host as the device does (the DeviceTrajectory
        contract: bit-identical to the file's float decode)."""
        idx = torch.as_tensor(ids, device=dt.pos.device)
        pos = dt.pos[idx].cpu().numpy()
        boxes = dt.boxes[idx].cpu().numpy().astype(np.float32)
        if dt.kind == "q16":
            inv = dt.inv_prec[idx].cpu().numpy().astype(np.float32)
            pos = pos.astype(np.float32) * inv[:, None, None]
        return np.asarray(pos, np.float32), boxes

    def _finish_dense_guards(self, out, frames_of) -> None:
        """Strict dense hbonds: every frame whose in-step guard count is
        nonzero had a decision within float reach of its threshold; its
        counts are replaced by the exact cell path's on the frames from
        `frames_of(ids)` (JAX `models/pipeline.py:1361-1389`,
        `:1430-1467`).  The guard keys never reach the caller."""
        self.last_guards, self.last_rescore_seconds = {}, {}
        for nm, analysis in self.dense_strict:
            g = out.pop(f"__guard__{nm}", None)
            if g is None:
                continue
            self.last_guards[nm] = g = np.asarray(g)
            bad = np.nonzero(g > 0)[0]
            if bad.size == 0:
                continue
            t0 = time.perf_counter()
            pos, boxes = frames_of(bad)
            res = analysis.analyze_batch(pos, boxes, counts_only=True)
            for pair in analysis.pairs:
                key = f"{nm}_{pair[0]}_{pair[1]}"
                fixed = np.asarray(out[key]).copy()
                fixed[bad] = res[pair]
                out[key] = fixed
            self.last_rescore_seconds[nm] = time.perf_counter() - t0


def run_many(analyses, trajectory, *, batch_size: int = 32):
    """Run several analyses over ONE device-resident trajectory and fetch
    every pass's results in a single packed fetch (one transfer per
    dtype) -> a list of result dicts, each equal to that analysis's own
    `runner.run(trajectory)` on the per-batch resident path.

    `analyses`: `TrajectoryAnalysis` (compiled here) or `PipelineRunner`
    instances.  A bare analysis compiles for the trajectory's layout:
    with `ship="all"` when the trajectory holds every atom (`sel` None),
    else with the default union of touched atoms, which must then be the
    trajectory's (build runners for a group layout yourself)."""
    from ..parallel.engine import DeviceTrajectory, FrameEngine

    if not isinstance(trajectory, DeviceTrajectory):
        raise ParallelError("run_many analyses a DeviceTrajectory; load one "
                            "with runner.load_device(filename)")
    if not analyses:
        return []
    ship = "all" if trajectory.sel is None else "auto"
    runners = [a.runner(ship=ship) if isinstance(a, TrajectoryAnalysis) else a
               for a in analyses]
    sets = []
    for r in runners:
        r._refuse_cells()
        r._check_layout(trajectory)
        sets.append(r._engine_1dev().run_resident(trajectory, batch_size=batch_size,
                                                  fetch=False))
    results = FrameEngine.fetch_packed_many(sets)
    for r, out in zip(runners, results):
        r._finish_dense_guards(out, lambda ids: r._window_frames(trajectory, ids))
        out["times"] = trajectory.times
        out["steps"] = trajectory.steps
    return results


# ------------------------------------------------- loaders shared by the models
# (JAX `models/pipeline.py:1546-1790`)

def _system_triclinic(system) -> bool:
    """True when the system's box needs box-matrix forms: the models load
    a triclinic system with `[F, 3, 3]` boxes and take the exact triclinic
    math (the reference's own RMSD is orthogonal-only, lib.rs:353-355)."""
    box = system.get_box()
    return box is not None and not box.is_orthogonal()


def _resident_group_cols(system, dtraj, group, gsel):
    """Column indices of `group`'s atoms inside a DeviceTrajectory's
    shipped-atom layout (raises if the layout misses any)."""
    shipped = getattr(dtraj, "sel", None)
    if shipped is None:
        return gsel
    lut = np.full(int(system.get_n_atoms()), -1, np.int64)
    lut[np.asarray(shipped)] = np.arange(len(shipped))
    cols = lut[gsel]
    if (cols < 0).any():
        raise ParallelError(
            f"the DeviceTrajectory's shipped layout does not contain "
            f"every atom of group '{group}'; load with ship='all' or "
            "runner(group=...)")
    return cols


def _group_frames(system, trajectory, group, gsel, batch_size,
                  start_time=None, end_time=None, step=None):
    """The group's window: a DeviceTrajectory given by the caller (its
    columns of the group) or one loaded through `runner(group=group)`
    from a filename -> (DeviceTrajectory, columns)."""
    from ..parallel.engine import DeviceTrajectory

    if isinstance(trajectory, DeviceTrajectory):
        if any(v is not None for v in (start_time, end_time, step)):
            raise ParallelError(
                "a DeviceTrajectory already fixes its frame window; apply "
                "-b/-e/--step when loading it (load_device(start_time=...))")
        return trajectory, _resident_group_cols(system, trajectory, group, gsel)
    runner = TrajectoryAnalysis(
        system, device=system.device,
        triclinic=_system_triclinic(system)).runner(group=group)
    dt = runner.load_device(trajectory, batch_size=batch_size,
                            start_time=start_time, end_time=end_time, step=step)
    return dt, np.arange(len(gsel))


def _window_pos(dt, cols, device):
    """The window's float32 positions of `cols` `[F, K, 3]` and its boxes
    on `device`, dequantized as the engine does (`q.float() * inv_prec`,
    bit-identical to the file's float decode)."""
    j = torch.as_tensor(np.asarray(cols), dtype=torch.int64, device=dt.pos.device)
    pos = dt.pos.index_select(1, j)
    if dt.kind == "q16":
        pos = pos.to(torch.float32) * dt.inv_prec[:, None, None]
    return pos.to(device), dt.boxes.to(device)


def _resident_group_pos(system, trajectory, group, batch_size,
                        start_time=None, end_time=None, step=None):
    """Shared loader: the group's float32 positions `[F, K, 3]` and boxes
    (`[F, 3]` lengths, or `[F, 3, 3]` matrices for a triclinic system) on
    the System's device, its global indices and the DeviceTrajectory.

    `group` is an existing group name or a GSL query (compiled into a
    transient group for the load).  The time window applies at load; a
    DeviceTrajectory already fixes its frame set, so combining one with a
    window raises."""
    tmp = None
    try:
        system.group_indices(group)
    except GroupError:
        tmp = "__resident_sel"
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            system.group_create(tmp, group)
        group = tmp
    try:
        gsel = np.asarray(system.group_indices(group))
        if gsel.size == 0:
            raise GroupError(f"group '{group}' is empty", code="EmptyGroup")
        dt, cols = _group_frames(system, trajectory, group, gsel, batch_size,
                                 start_time, end_time, step)
    finally:
        if tmp is not None:
            system.group_remove(tmp)
    pos, boxes = _window_pos(dt, cols, system.device)
    return gsel, pos, boxes, dt


_E_OVER_EPS0_NM = 18.0951262     # e/(eps0 * nm) in volts (CODATA 2018)

_EPSILON0 = 5.727657e-4     # vacuum permittivity, e^2 mol / (kJ nm)

_BOLTZ = 8.3144626e-3       # Boltzmann constant, kJ / (mol K)

_AXIS = {"x": 0, "y": 1, "z": 2}

_AMU_NM_PS_TO_PAS = 1.66053906660e-6   # amu/(nm ps) -> Pa s

_G1_SITE_WIDTH = {"vector": 2, "plane": 3}   # atoms per gangle site

# X-ray form factors (Cromer-Mann a, b, c per element), atomic numbers
# and coherent neutron scattering lengths (fm), as the JAX package has
# them (`models/pipeline.py:1662-1700`)
_CROMER_MANN = {
    "H": ([0.489918, 0.262003, 0.196767, 0.049879],
          [20.6593, 7.74039, 49.5519, 2.20159], 0.001305),
    "C": ([2.31000, 1.02000, 1.58860, 0.865000],
          [20.8439, 10.2075, 0.568700, 51.6512], 0.215600),
    "N": ([12.2126, 3.13220, 2.01250, 1.16630],
          [0.005700, 9.89330, 28.9975, 0.582600], -11.529),
    "O": ([3.04850, 2.28680, 1.54630, 0.867000],
          [13.2771, 5.70110, 0.323900, 32.9089], 0.250800),
    "P": ([6.43450, 4.17910, 1.78000, 1.49080],
          [1.90670, 27.1570, 0.526000, 68.1645], 1.11490),
    "S": ([6.90530, 5.20340, 1.43790, 1.58630],
          [1.46790, 22.2151, 0.253600, 56.1720], 0.866900),
    "NA": ([4.76260, 3.17360, 1.26740, 1.11280],
           [3.28500, 8.84220, 0.313600, 129.424], 0.676000),
    "MG": ([5.42040, 2.17350, 1.22690, 2.30730],
           [2.82750, 79.2611, 0.380800, 7.19370], 0.858400),
    "CL": ([11.4604, 7.19640, 6.25560, 1.64550],
           [0.010400, 1.16620, 18.5194, 47.7784], -9.5574),
    "K": ([8.21860, 7.43980, 1.05190, 0.865900],
          [12.7949, 0.774800, 213.187, 41.6841], 1.42280),
    "CA": ([8.62660, 7.38730, 1.58990, 1.02110],
           [10.4421, 0.659900, 85.7484, 178.437], 1.37510),
    "FE": ([11.7695, 7.35730, 3.52220, 2.30450],
           [4.76110, 0.307200, 15.3535, 76.8805], 1.03690),
    "ZN": ([14.0743, 7.03180, 5.16520, 2.41000],
           [3.26550, 0.233300, 10.3163, 58.7097], 1.30410),
}

_CM_Z = {"H": 1, "C": 6, "N": 7, "O": 8, "P": 15, "S": 16, "NA": 11,
         "MG": 12, "CL": 17, "K": 19, "CA": 20, "FE": 26, "ZN": 30}

_NEUTRON_B = {
    "H": -3.7406, "D": 6.671, "C": 6.6511, "N": 9.37, "O": 5.803,
    "P": 5.13, "S": 2.847, "NA": 3.63, "MG": 5.375, "CL": 9.577,
    "K": 3.67, "CA": 4.70, "FE": 9.45, "ZN": 5.680,
}

_KB_KJ = 0.00831446261815324        # kJ/mol/K (CODATA)


def _unit_tables(system, idx, blocks, loc, *, charges=False):
    """Padded per-unit site tables (JAX `models/pipeline.py:1738-1759`):
    `blocks` hold local indices into `idx` (as `_blocks_by_key` returns
    them), `loc` maps idx order to the shipped group layout.  Returns
    group-layout columns [U, P], mass weights normalised per unit [U, P],
    raw charges [U, P] (zero-padded; zeros without `charges`) and the
    per-unit net charge [U].  Built with array operations (200k water
    molecules in `dipole_corr`); the tables equal the JAX ones."""
    from ..system.rmsd import _masses

    sizes = np.fromiter((len(b) for b in blocks), np.int64, len(blocks))
    flat = np.concatenate([np.asarray(b, np.int64) for b in blocks])
    row = np.repeat(np.arange(len(blocks)), sizes)
    col = np.arange(flat.shape[0]) - np.repeat(np.cumsum(sizes) - sizes, sizes)
    p = int(sizes.max())
    cols = np.zeros((len(blocks), p), np.int64)
    w = np.zeros((len(blocks), p), np.float32)
    qt = np.zeros((len(blocks), p), np.float32)
    gmass = np.asarray(_masses(system, "unit table", idx), np.float64)
    cols[row, col] = np.asarray(loc)[flat]
    w[row, col] = gmass[flat]
    w /= w.sum(axis=1, keepdims=True)
    if charges:
        qt[row, col] = np.asarray(system.topology.charge, np.float64)[np.asarray(idx)[flat]]
    return cols, w, qt, qt.sum(axis=1)


def _blocks_by_key(key):
    """Local indices grouped by equal `key` rows ([K] or [K, c]) in order
    of first appearance -> (first local index of each block, blocks: each
    an ascending local-index array)."""
    _, first, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
    rank = np.empty(first.shape[0], np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(first.shape[0])
    block_of = rank[inv.reshape(-1)]
    order = np.argsort(block_of, kind="stable")
    bounds = np.searchsorted(block_of[order], np.arange(first.shape[0] + 1))
    return np.sort(first), [order[bounds[i]:bounds[i + 1]]
                            for i in range(first.shape[0])]


def _residue_blocks(system, gsel):
    """Group atoms split by (chain, resnum) in order of appearance ->
    (resids [R], resnames [R], blocks: local-index arrays into the group's
    own 0..K-1 layout, each ascending)."""
    topo = system.topology
    gsel = np.asarray(gsel)
    heads, blocks = _blocks_by_key(np.stack(
        [topo.chain.codes[gsel].astype(np.int64), np.asarray(topo.resnum)[gsel]], 1))
    resids = np.asarray(topo.resnum)[gsel[heads]].astype(np.int64)
    resnames = np.asarray(topo.resname.categories, object)[
        topo.resname.codes[gsel[heads]]]
    return resids, resnames, blocks


def _sel_indices(system, sel: str) -> np.ndarray:
    """Indices for `sel`: an existing group name, or a GSL query."""
    try:
        return np.asarray(system.group_indices(sel))
    except GroupError:
        from ..select.compile import select_to_mask

        return np.flatnonzero(select_to_mask(sel, system))


def _transient_indices(system, spec: str) -> np.ndarray:
    """Global atom indices of a group name or GSL query."""
    try:
        return np.asarray(system.group_indices(spec))
    except GroupError:
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            system.group_create("__transient_sel", spec)
        try:
            return np.asarray(system.group_indices("__transient_sel"))
        finally:
            system.group_remove("__transient_sel")


_CHI_SITES = [
    # chi_k: 4 atom names; alternatives per slot, first present wins
    (("N",), ("CA",), ("CB",), ("CG", "CG1", "OG", "OG1", "SG")),
    (("CA",), ("CB",), ("CG", "CG1"), ("CD", "CD1", "OD1", "ND1", "SD")),
    (("CB",), ("CG",), ("CD", "SD"), ("CE", "OE1", "NE")),
    (("CG",), ("CD",), ("CE", "NE"), ("NZ", "CZ")),
]


class _named_group:
    """Context manager: `group` verbatim if it names an existing group,
    else a transient group compiled from it as a GSL query."""

    def __init__(self, system, group, tmp):
        self.system, self.group, self.tmp = system, group, tmp

    def __enter__(self):
        try:
            self.system.group_indices(self.group)
            self.tmp = None
            return self.group
        except GroupError:
            self.system.group_create_from_indices(
                self.tmp, _transient_indices(self.system, self.group))
            return self.tmp

    def __exit__(self, *exc):
        if self.tmp is not None:
            self.system.group_remove(self.tmp)
        return False


# The analysis families live in sibling modules; every name stays
# importable from here (PEP 562), as in the JAX package.
_SPLIT_MODULES = {name: "structure" for name in (
    "_connected_components", "_fit_inputs", "_pca_math", "chi", "cluster",
    "clustsize", "cosine_content", "dccm", "dssp", "entropy", "mdmat",
    "mode_traj", "morph", "pca", "ramachandran", "rmsd_matrix", "rmsdist",
    "rmsf", "rotmat", "subspace_overlap")}
_SPLIT_MODULES.update({name: "dynamics" for name in (
    "_hbond_curve", "_hbond_h_matrix", "current", "diffusion", "dipole_corr",
    "dos", "filter_traj", "hbond_acf", "hbond_lifetime", "msd", "msd_mol",
    "rotacf", "tcaf", "vacf", "vanhove")})
_SPLIT_MODULES.update({name: "membrane" for name in (
    "_water_sites", "densmap", "densorder", "h2order", "hydorder", "leaflets",
    "order_parameters", "potential_profile", "sorient", "spol")})
_SPLIT_MODULES.update({name: "geometry" for name in (
    "bundle", "dyecoupl", "freevolume", "gangle", "helixorient", "pairdist",
    "pi_mindist", "polystat", "saltbr", "sasa", "sdf", "select_dynamic",
    "trjorder", "write_cube")})
_SPLIT_MODULES.update({name: "scattering" for name in (
    "_cm_form_factors", "_debye_curve", "_group_elements", "sans", "saxs")})
_SPLIT_MODULES.update({name: "freeenergy" for name in (
    "_debye_eps", "bar", "bar_intervals", "dielectric", "dielectric_spectrum",
    "lie", "wham")})


def __getattr__(name):
    mod = _SPLIT_MODULES.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module("." + mod, __package__), name)


def __dir__():
    return sorted(set(globals()) | set(_SPLIT_MODULES))
