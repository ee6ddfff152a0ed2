"""The benchmark's synthetic membrane-protein system, made from `--seed`.

Frozen copy of the builders of `groan_rs_tpu_torch/testing.py` at commit
14410646bb8b46a8e0fcf9fa6d0b96e5dfbab158 (`build_trajectory`,
`build_trajectory_triclinic`, `_cell_order`, `dodecahedron`,
`put_atoms_in_box`, `synthetic_sizes`, `synthetic_layout`,
`synthetic_state`, `cylinder_args`; themselves the JAX bench's,
`bench.py:53-179`), changed in three ways:

- every random draw comes from the run's seed, and positions and the
  drift are drawn on the run's device by a `torch.Generator`, frame 0 in
  a few large calls and the drift in one call a frame (the same seed on
  the same device gives the same draws; every seed draws the same sizes);
- frames are made on the XTC precision grid: frame 0 is rounded to the
  grid once and each frame adds its rounded drift (orthorhombic: modulo
  the box on the grid; dodecahedron: wrapped into the brick in float64,
  then rounded).  The grid is what the file holds exactly, and what the
  plain reference reads;
- a frame depends only on frame 0 and the drift up to it, so a shorter
  trajectory of the same seed is a prefix of a longer one, and
  `Synthetic.grid_frames` can make any range again after the window.

Layout (as `testing.synthetic_layout`): Protein [0, n_prot) a Gaussian blob,
Membrane [n_prot, w0) 50-atom lipids (heads in a slab, tails a short
walk), Water [w0, n) O-H-H triplets, each sorted cell-major as solvate
tools lay molecules out; Peptide the first `n_peptide` Protein atoms.
"""

from __future__ import annotations

import numpy as np
import torch


def seed_of(seed: int, stream: int) -> int:
    """A 63-bit seed of stream `stream` of the run seed `seed` (any
    non-negative integer, also above 2**32)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), int(stream)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def dodecahedron(d: float) -> np.ndarray:
    """Float32 box matrix of the xy-square rhombic dodecahedron of image
    distance `d` (GROMACS `editconf -bt dodecahedron`)."""
    return np.array([[d, 0.0, 0.0], [0.0, d, 0.0],
                     [d / 2, d / 2, d * np.sqrt(2.0) / 2]], np.float32)


def _cell_order(points: torch.Tensor, cell: float = 0.5) -> torch.Tensor:
    """Cell-major spatial sort (x cell, then y, then z), stable."""
    key = torch.floor(points / cell).to(torch.int64)
    key = key - key.min(0).values
    span = key.max(0).values + 1
    flat = (key[:, 0] * span[1] + key[:, 1]) * span[2] + key[:, 2]
    return torch.argsort(flat, stable=True)


def put_atoms_in_box(pos: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Wrap `pos` [..., 3] into the diagonal brick of the lower-triangular
    box `h`, as GROMACS's `put_atoms_in_box`: by c for z, then b for y,
    then a for x."""
    pos = pos.clone()
    for ax in (2, 1, 0):
        k = torch.floor(pos[..., ax] / h[ax, ax])
        pos -= k[..., None] * h[ax]
        hi = pos[..., ax] >= h[ax, ax]
        pos[hi] -= h[ax]
        lo = pos[..., ax] < 0
        pos[lo] += h[ax]
    return pos


class Synthetic:
    """The system of configuration `config` (a dict from
    `portbench/configs/<name>.json`) under seed `seed` on `device`."""

    def __init__(self, config: dict, seed: int, device, n_frames: int | None = None):
        self.config = config
        self.seed = int(seed)
        self.device = torch.device(device)
        self.n = int(config["n_atoms"])
        g = config["groups"]
        self.n_prot = g["Protein"][1] - g["Protein"][0]
        self.n_mem = g["Membrane"][1] - g["Membrane"][0]
        self.n_pep = g["Peptide"][1] - g["Peptide"][0]
        self.w0 = self.n_prot + self.n_mem
        self.lipid = int(config["lipid_size"])
        self.precision = float(config["precision"])
        self.dt_ps = float(config["dt_ps"])
        self.n_frames = int(config["frames"] if n_frames is None else n_frames)
        box = config["box"]
        self.triclinic = box["form"] == "dodecahedron"
        if self.triclinic:
            self.h = dodecahedron(float(box["image_distance_nm"]))
        else:
            self.h = np.diag(np.asarray(box["lengths_nm"], np.float32)).astype(np.float32)
        self.box9 = self.h.reshape(9).copy()
        self._q0 = None

    # -------------------------------------------------------------- frames
    def _frame0(self) -> torch.Tensor:
        """Frame 0 in float32 nm on the device (`build_trajectory`'s or
        `build_trajectory_triclinic`'s layout)."""
        dev, f32 = self.device, torch.float32
        gen = torch.Generator(device=dev).manual_seed(seed_of(self.seed, 0))
        n_prot, n_mem, n = self.n_prot, self.n_mem, self.n
        brick = torch.as_tensor(np.diag(self.h).copy(), dtype=f32, device=dev)
        pos = torch.empty((n, 3), dtype=f32, device=dev)
        sigma = max(1.0, (n_prot / 100.0) ** (1.0 / 3.0) / 2.0)
        prot = torch.randn((n_prot, 3), generator=gen, device=dev) * sigma
        if not self.triclinic:
            prot = prot + brick / 2          # the blob at the box centre
        pos[:n_prot] = prot[_cell_order(prot)]
        n_lip = (n_mem + self.lipid - 1) // self.lipid
        heads = torch.rand((n_lip, 3), generator=gen, device=dev) * brick
        if self.triclinic:                   # the slab on the plane z = 0
            heads[:, 2] = (heads[:, 2] / brick[2] - 0.5) * 5.0
        else:                                # z in [8, 13)
            heads[:, 2] = 8.0 + heads[:, 2] / brick[2] * 5.0
        heads = heads[_cell_order(heads, cell=1.0)]
        walk = torch.cumsum(torch.randn((n_lip, self.lipid, 3), generator=gen,
                                        device=dev) * 0.08, dim=1)
        pos[n_prot:n_prot + n_mem] = (heads[:, None, :] + walk).reshape(-1, 3)[:n_mem]
        n_wat = n - n_prot - n_mem
        n_mol = (n_wat + 2) // 3
        centers = torch.rand((n_mol, 3), generator=gen, device=dev) * brick
        centers = centers[_cell_order(centers)]
        offsets = torch.randn((n_mol, 2, 3), generator=gen, device=dev) * 0.06
        trip = torch.stack([centers, centers + offsets[:, 0], centers + offsets[:, 1]], 1)
        pos[n_prot + n_mem:] = trip.reshape(-1, 3)[:n_wat]
        return pos

    def _on_grid(self, pos: torch.Tensor) -> torch.Tensor:
        """Float positions -> int32 grid points, wrapped into the box."""
        if self.triclinic:
            h = torch.as_tensor(self.h, dtype=torch.float64, device=pos.device)
            pos = put_atoms_in_box(pos.to(torch.float64), h)
            return torch.round(pos * self.precision).to(torch.int32)
        lq = torch.as_tensor(np.round(np.diag(self.h).astype(np.float64) * self.precision),
                             dtype=torch.int64, device=pos.device)
        q = torch.round(pos.to(torch.float64) * self.precision).to(torch.int64)
        return torch.remainder(q, lq).to(torch.int32)

    def grid_frame0(self) -> torch.Tensor:
        """Frame 0 on the grid, int32 [N, 3] on the device."""
        if self._q0 is None:
            self._q0 = self._on_grid(self._frame0())
        return self._q0

    def grid_frames(self, start: int = 0, stop: int | None = None):
        """Yield (f, int32 [N, 3] grid frame on the device) for frames
        `start` to `stop`, drawing the drift again from the seed."""
        stop = self.n_frames if stop is None else stop
        dev = self.device
        q0 = self.grid_frame0()
        gen = torch.Generator(device=dev).manual_seed(seed_of(self.seed, 1))
        disp = torch.zeros((self.n, 3), dtype=torch.float32, device=dev)
        if start == 0 and stop > 0:
            yield 0, q0
        for f in range(1, stop):
            # one draw a frame: a trajectory is a prefix of any longer one
            disp += (torch.randn((1, 3), generator=gen, device=dev) * 0.05
                     + torch.randn((self.n, 3), generator=gen, device=dev) * 0.01)
            if f < start:
                continue
            if self.triclinic:
                pos = q0.to(torch.float64) / self.precision + disp.to(torch.float64)
                yield f, self._on_grid(pos)
            else:
                step = torch.round(disp.to(torch.float64) * self.precision)
                yield f, self._on_grid_shift(q0, step)

    def _on_grid_shift(self, q0: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
        lq = torch.as_tensor(np.round(np.diag(self.h).astype(np.float64) * self.precision),
                             dtype=torch.int64, device=q0.device)
        return torch.remainder(q0.to(torch.int64) + step.to(torch.int64), lq).to(torch.int32)

    def positions(self, q: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
        """Grid points -> nm (float64 by default: exact on the grid)."""
        return q.to(torch.float64).div(self.precision).to(dtype)

    def host_frames(self, stop: int | None = None):
        """Yield the int32 [N, 3] grid frames as host numpy arrays."""
        for _, q in self.grid_frames(0, stop):
            yield q.cpu().numpy()

    # -------------------------------------------------------------- state
    def layout(self) -> dict:
        """Index tables of the layout (`testing.synthetic_layout`)."""
        n, n_prot, n_mem, w0 = self.n, self.n_prot, self.n_mem, self.w0
        mem = np.arange(n_mem)
        is_h = (mem % self.lipid) % 3 == 2
        heavy = mem[~is_h]
        same = heavy[:-1] // self.lipid == heavy[1:] // self.lipid
        chain = np.stack([heavy[:-1][same], heavy[1:][same]], 1) + n_prot
        hyd = mem[is_h] + n_prot
        quad = np.stack([heavy[:-3], heavy[1:-2], heavy[2:-1], heavy[3:]], 1)
        quad = quad[quad[:, 0] // self.lipid == quad[:, 3] // self.lipid] + n_prot
        oxy = np.arange(w0, n, 3)
        whole = oxy[oxy + 2 < n]
        return {
            "lipid_hydrogens": hyd,
            "lipid_bonds": np.concatenate([chain, np.stack([hyd - 1, hyd], 1)]),
            "water_oxygens": oxy,
            "water_bonds": np.concatenate(
                [np.stack([oxy, oxy + k], 1)[oxy + k < n] for k in (1, 2)]),
            "water_angles": np.stack([whole + 1, whole, whole + 2], 1),
            "lipid_dihedrals": quad,
        }

    def masses(self) -> np.ndarray:
        rng = np.random.default_rng(seed_of(self.seed, 2))
        return rng.uniform(1.0, 16.0, size=self.n).astype(np.float32)

    def charges(self) -> np.ndarray:
        """TIP3P-like water (O -0.834, H +0.417), a net-neutral drawn
        pattern on the Protein, neutral lipids."""
        rng = np.random.default_rng(seed_of(self.seed, 3))
        q = np.zeros(self.n, np.float64)
        qp = rng.uniform(-0.5, 0.5, self.n_prot)
        q[:self.n_prot] = qp - qp.mean()
        q[self.w0:] = 0.417
        q[np.arange(self.w0, self.n, 3)] = -0.834
        return q.astype(np.float32)

    def state(self, topology: str | None = None) -> dict:
        """The System state handed to the program (`convert.system_from_state`):
        frame 0 in float32 nm, the box, masses, groups; `topology="full"`
        adds charges, bonds, elements, atom names, the Water group and
        the angle and dihedral sites."""
        n, n_prot, w0 = self.n, self.n_prot, self.w0
        frame0 = self.positions(self.grid_frame0(), torch.float32).cpu().numpy()
        box = self.h if self.triclinic else np.diag(self.h).copy()
        state = {
            "name": "synthetic",
            "positions": frame0,
            "box": np.asarray(box, np.float32),
            "mass": self.masses(),
            "has_mass": np.ones(n, bool),
            "precision": int(self.precision),
            "groups": {
                "Protein": np.arange(n_prot),
                "Membrane": np.arange(n_prot, w0),
                "Peptide": np.arange(self.n_pep),
            },
        }
        if topology is None:
            return state
        if topology != "full":
            raise ValueError(f"unknown topology '{topology}' (None or 'full')")
        lay = self.layout()
        oxy, hyd = lay["water_oxygens"], lay["lipid_hydrogens"]
        element = np.full(n, "C", "<U2")
        name = np.full(n, "CA", "<U3")
        name[n_prot:w0] = "C"
        element[hyd] = name[hyd] = "H"
        element[w0:] = "H"
        element[oxy] = "O"
        name[w0:] = np.asarray(["OW", "HW1", "HW2"])[(np.arange(w0, n) - w0) % 3]
        state.update({
            "charge": self.charges(),
            "has_charge": np.ones(n, bool),
            "bonds": np.concatenate([lay["lipid_bonds"], lay["water_bonds"]]),
            "element": element,
            "atomname": name,
            "sites": {"water_angles": lay["water_angles"],
                      "lipid_dihedrals": lay["lipid_dihedrals"]},
        })
        state["groups"]["Water"] = np.arange(w0, n)
        return state

    def cylinder_args(self):
        """(position, radius, height) of the in-shape cylinder: z-oriented
        through the box centre, from 10% to 80% of the box height."""
        box = np.diag(self.h).astype(np.float64)
        return ([box[0] / 2, box[1] / 2, 0.1 * box[2]], 0.2 * min(box[0], box[1]),
                0.7 * box[2])


def make(config: dict, seed: int, device, n_frames: int | None = None) -> Synthetic:
    """The generator's entry (`gen/<generator>.py` `make`, see `gen/__init__.py`)."""
    return Synthetic(config, seed, device, n_frames=n_frames)
