"""A box of rigid SPC waters made from `--seed` (`"generator": "water"`).

The configuration gives the atom count (three atoms a molecule, O, H, H,
named OW, HW1, HW2), the cubic box, the precision and the frame spacing.
What a published box would fix but the repository does not hold is drawn
from the seed:

- frame 0: the oxygens on a cubic lattice of `side`^3 sites, `side` the
  smallest whose cube holds every molecule (64 for 256,000), spacing
  edge / side; the occupied sites drawn from the seed and kept in lattice
  order, each oxygen jittered by N(0, `JITTER_NM`) per axis; each
  molecule's orientation uniformly random (a normalised Gaussian
  quaternion);
- frame to frame, each molecule moves rigidly: its oxygen by a step of
  N(0, `STEP_NM`) per axis, its hydrogens rotated about the oxygen by a
  rotation of N(0, `TURN_DEG`) degrees about a uniformly random axis;
- SPC geometry (O-H `OH_NM`, H-O-H `HOH_DEG`), masses and charges.

Positions are kept in float64 on the device, unwrapped, and each frame is
rounded to the XTC precision grid and wrapped atom by atom into the box
(modulo the box on the grid), as GROMACS writes them.  Every draw comes
from a `torch.Generator` of the run's seed on the run's device, frame 0
from one stream and the motion from another, one fixed set of draws a
frame: a shorter trajectory of a seed is a prefix of a longer one, and
`grid_frames` makes any range again.

`layout()` holds the tables the hydrogen-bond oracle reads: the atom
names, the oxygens, each oxygen's two hydrogens and the O-H bonds.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.gen.synthetic import seed_of

OH_NM = 0.1
HOH_DEG = 109.47
MASS = (15.9994, 1.008, 1.008)
CHARGE = (-0.82, 0.41, 0.41)
NAMES = ("OW", "HW1", "HW2")
JITTER_NM = 0.02
STEP_NM = 0.02
TURN_DEG = 15.0


def lattice_side(n_mol: int) -> int:
    """The smallest cubic lattice side whose cube holds `n_mol` sites."""
    side = 1
    while side ** 3 < n_mol:
        side += 1
    return side


def _body_hydrogens(dtype, device) -> torch.Tensor:
    """The two hydrogens' offsets from the oxygen in the molecule's own
    frame [2, 3]: in the xy plane, symmetric about y."""
    half = math.radians(HOH_DEG) / 2
    s, c = OH_NM * math.sin(half), OH_NM * math.cos(half)
    return torch.tensor([[s, c, 0.0], [-s, c, 0.0]], dtype=dtype, device=device)


def _quat_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [M, 3, 3] of unit quaternions q [M, 4] (w, x, y, z)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [M, 3, 3] about unit `axis` [M, 3] by `angle` [M] rad
    (Rodrigues)."""
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    k = torch.stack([torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
                     torch.stack([-y, x, zero], -1)], -2)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    s, c = torch.sin(angle)[:, None, None], torch.cos(angle)[:, None, None]
    return eye + s * k + (1 - c) * _matmul(k, k)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for [M, 3, 3] stacks, as elementwise products and sums (the
    same bits on every call on one device)."""
    return (a[:, :, :, None] * b[:, None, :, :]).sum(2)


class Water:
    """The water box of configuration `config` under seed `seed` on `device`."""

    triclinic = False

    def __init__(self, config: dict, seed: int, device, n_frames: int | None = None):
        self.config = config
        self.seed = int(seed)
        self.device = torch.device(device)
        self.n = int(config["n_atoms"])
        if self.n % 3:
            raise ValueError(f"n_atoms {self.n} is no whole number of 3-atom waters")
        self.n_mol = self.n // 3
        self.side = lattice_side(self.n_mol)
        self.precision = float(config["precision"])
        self.dt_ps = float(config["dt_ps"])
        self.n_frames = int(config["frames"] if n_frames is None else n_frames)
        box = config["box"]
        if box["form"] != "rectangular":
            raise ValueError(f"the water box is rectangular, not '{box['form']}'")
        self.h = np.diag(np.asarray(box["lengths_nm"], np.float32)).astype(np.float32)
        self.box9 = self.h.reshape(9).copy()
        self._lq = np.round(np.diag(self.h).astype(np.float64) * self.precision)
        self._q0 = None

    # -------------------------------------------------------------- frames
    def _start(self):
        """(oxygens [M, 3] nm, orientations [M, 3, 3]) of frame 0, float64."""
        dev, f64 = self.device, torch.float64
        gen = torch.Generator(device=dev).manual_seed(seed_of(self.seed, 0))
        side = self.side
        sites = torch.randperm(side ** 3, generator=gen, device=dev)[:self.n_mol]
        sites = torch.sort(sites).values
        ijk = torch.stack([sites // (side * side), (sites // side) % side, sites % side], 1)
        spacing = torch.as_tensor(np.diag(self.h).astype(np.float64) / side, device=dev)
        oxy = (ijk.to(f64) + 0.5) * spacing
        oxy = oxy + torch.randn((self.n_mol, 3), generator=gen, device=dev,
                                dtype=f64) * JITTER_NM
        quat = torch.randn((self.n_mol, 4), generator=gen, device=dev, dtype=f64)
        quat = quat / torch.linalg.vector_norm(quat, dim=1, keepdim=True).clamp_min(1e-12)
        return oxy, _quat_matrix(quat)

    def _step(self, gen, oxy, rot):
        """The next frame's (oxygens, orientations): one rigid move a molecule."""
        dev, f64 = self.device, torch.float64
        oxy = oxy + torch.randn((self.n_mol, 3), generator=gen, device=dev,
                                dtype=f64) * STEP_NM
        axis = torch.randn((self.n_mol, 3), generator=gen, device=dev, dtype=f64)
        axis = axis / torch.linalg.vector_norm(axis, dim=1, keepdim=True).clamp_min(1e-12)
        angle = torch.randn(self.n_mol, generator=gen, device=dev,
                            dtype=f64) * math.radians(TURN_DEG)
        return oxy, _matmul(_axis_angle(axis, angle), rot)

    def _atoms(self, oxy, rot) -> torch.Tensor:
        """Float64 positions [N, 3]: O, H, H a molecule."""
        body = _body_hydrogens(oxy.dtype, oxy.device)
        hyd = [oxy + (rot * body[k][None, None, :]).sum(-1) for k in range(2)]
        return torch.stack([oxy, *hyd], 1).reshape(-1, 3)

    def _on_grid(self, pos: torch.Tensor) -> torch.Tensor:
        """Float64 nm -> int32 grid points, each atom wrapped into the box."""
        lq = torch.as_tensor(self._lq, dtype=torch.int64, device=pos.device)
        q = torch.round(pos * self.precision).to(torch.int64)
        return torch.remainder(q, lq).to(torch.int32)

    def grid_frame0(self) -> torch.Tensor:
        """Frame 0 on the grid, int32 [N, 3] on the device."""
        if self._q0 is None:
            self._q0 = self._on_grid(self._atoms(*self._start()))
        return self._q0

    def grid_frames(self, start: int = 0, stop: int | None = None):
        """Yield (f, int32 [N, 3] grid frame on the device) for frames
        `start` to `stop`, drawing the motion again from the seed."""
        stop = self.n_frames if stop is None else stop
        if stop <= 0:
            return
        oxy, rot = self._start()
        gen = torch.Generator(device=self.device).manual_seed(seed_of(self.seed, 1))
        if start == 0:
            yield 0, self.grid_frame0()
        for f in range(1, stop):
            oxy, rot = self._step(gen, oxy, rot)
            if f >= start:
                yield f, self._on_grid(self._atoms(oxy, rot))

    def positions(self, q: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
        """Grid points -> nm (float64 by default: exact on the grid)."""
        return q.to(torch.float64).div(self.precision).to(dtype)

    def host_frames(self, stop: int | None = None):
        """Yield the int32 [N, 3] grid frames as host numpy arrays."""
        for _, q in self.grid_frames(0, stop):
            yield q.cpu().numpy()

    # -------------------------------------------------------------- state
    def layout(self) -> dict:
        """The tables of the box: `atom_names` [N], `oxygens` [M],
        `hydrogens` [M, 2] (each oxygen's two), `bonds` [2M, 2] (O-H)."""
        oxy = np.arange(0, self.n, 3, dtype=np.int64)
        hyd = np.stack([oxy + 1, oxy + 2], 1)
        return {
            "atom_names": np.tile(np.asarray(NAMES), self.n_mol),
            "oxygens": oxy,
            "hydrogens": hyd,
            "bonds": np.concatenate([np.stack([oxy, hyd[:, k]], 1) for k in range(2)]),
        }

    def masses(self) -> np.ndarray:
        return np.tile(np.asarray(MASS, np.float32), self.n_mol)

    def charges(self) -> np.ndarray:
        return np.tile(np.asarray(CHARGE, np.float32), self.n_mol)

    def state(self, topology: str | None = None) -> dict:
        """The System state handed to the program (`convert.system_from_state`):
        frame 0 in float32 nm, the box, masses, the Water group;
        `topology="full"` adds charges, the O-H bonds, elements and atom
        names."""
        frame0 = self.positions(self.grid_frame0(), torch.float32).cpu().numpy()
        state = {
            "name": "water",
            "positions": frame0,
            "box": np.diag(self.h).copy(),
            "mass": self.masses(),
            "has_mass": np.ones(self.n, bool),
            "precision": int(self.precision),
            "groups": {k: np.arange(*v) for k, v in self.config["groups"].items()},
        }
        if topology is None:
            return state
        if topology != "full":
            raise ValueError(f"unknown topology '{topology}' (None or 'full')")
        lay = self.layout()
        state.update({
            "charge": self.charges(),
            "has_charge": np.ones(self.n, bool),
            "bonds": lay["bonds"],
            "element": np.tile(np.asarray(["O", "H", "H"]), self.n_mol),
            "atomname": lay["atom_names"],
        })
        return state


def make(config: dict, seed: int, device, n_frames: int | None = None) -> Water:
    """The generator's entry (`gen/<generator>.py` `make`, see `gen/__init__.py`)."""
    return Water(config, seed, device, n_frames=n_frames)
