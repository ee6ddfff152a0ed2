"""The molecular System.

Port of `groan_rs_tpu/system/__init__.py` and `system/core.py`: topology,
box, the current frame's positions, velocities and forces (host numpy,
with presence masks), step, time, precision and lambda, index groups and
labeled atoms, with the method families of the sibling modules mixed in:
groups (`groups.py`), analysis (`analysis.py`), modifying
(`modifying.py`), iterating (`iterating.py`), labels and centring
(`utility.py`), RMSD (`rmsd.py`), guessing (`guess.py`) and hydrogen
bonds (`hbonds.py`).  The trajectory readers write each frame into the
host arrays (`io/traj.py`); the writers, `traj_iter_map_reduce` and the
iterators are reached from here.

`device` is where every per-call method computes: the CUDA card unless
the System was built with `device="cpu"` (or `set_device("cpu")`).  It
is resolved by `backend.require_cuda` at the first call that computes,
so a host without a card raises there; no method falls back to the CPU.
Positions stay host numpy: a method moves the rows it needs to the
device and writes modified positions back into `positions`.  TPR files
and TNG trajectories are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..backend import as_device, require_cuda
from ..core.atom import Atom
from ..core.container import AtomContainer
from ..core.simbox import SimBox, simbox_check
from ..core.topology import Topology
from ..errors import AtomError, FileTypeError, WriteTrajError
from ..files import FileType
from .analysis import AnalysisMixin, TriclinicAnalysisMixin
from .groups import Group, GroupsMixin
from .guess import GuessMixin
from .hbonds import HBondsMixin
from .iterating import IteratingMixin, PairIteratingMixin
from .modifying import ModifyingMixin
from .rmsd import RMSDMixin
from .utility import UtilityMixin

__all__ = ["System", "SystemExtrasMixin"]


def _vectors(arr, present, n):
    """(`[N, 3]` float32 array, bool `[N]` presence) of an optional
    per-atom vector (JAX `system/core.py:150-158`)."""
    if arr is None:
        return np.zeros((n, 3), np.float32), np.zeros(n, bool)
    arr = np.ascontiguousarray(np.asarray(arr, np.float32).reshape(n, 3))
    present = (np.ones(n, bool) if present is None
               else np.asarray(present, bool).reshape(n))
    return arr, present


class SystemExtrasMixin:
    """Reference-named conveniences (JAX `system/core.py:365-415`)."""

    def get_atoms(self) -> list:
        """All atoms as views (reference: System::get_atoms)."""
        return [self.get_atom(i) for i in range(self.get_n_atoms())]

    def get_atoms_copy(self) -> list:
        """reference: System::get_atoms_copy (views over a copied System)."""
        return self.copy().get_atoms()

    def get_atom_mut(self, index: int) -> Atom:
        return self.get_atom(index)

    def has_positions(self) -> bool:
        return bool(self.has_position.all()) and self.get_n_atoms() > 0

    def has_velocities(self) -> bool:
        return bool(self.has_velocity.all()) and self.get_n_atoms() > 0

    def has_forces(self) -> bool:
        return bool(self.has_force.all()) and self.get_n_atoms() > 0

    def has_duplicate_atom_numbers(self) -> bool:
        return len(np.unique(self.topology.atomnum)) != self.get_n_atoms()

    def get_box_mut(self):
        return self.get_box()

    def reset_box(self) -> None:
        self.set_box(None)

    def reset_mol_references(self) -> None:
        """Invalidate the cached molecule decomposition (recomputed on next
        use; reference: System::reset_mol_references)."""
        self.topology._invalidate_bonds()

    def get_groups_copy(self) -> dict:
        return {name: g.copy() for name, g in self.groups.items()}


class System(GroupsMixin, AnalysisMixin, TriclinicAnalysisMixin, ModifyingMixin,
             IteratingMixin, PairIteratingMixin, UtilityMixin, RMSDMixin,
             GuessMixin, HBondsMixin, SystemExtrasMixin):
    """The central object: topology + current frame + groups."""

    def __init__(self, name: str, topology: Topology, simbox: SimBox | None = None,
                 positions: np.ndarray | None = None,
                 velocities: np.ndarray | None = None,
                 forces: np.ndarray | None = None,
                 has_position: np.ndarray | None = None,
                 has_velocity: np.ndarray | None = None,
                 has_force: np.ndarray | None = None, device=None):
        n = topology.n_atoms
        self.name = name
        self.topology = topology
        self.simbox = simbox
        self.positions, self.has_position = _vectors(positions, has_position, n)
        self.velocities, self.has_velocity = _vectors(velocities, has_velocity, n)
        self.forces, self.has_force = _vectors(forces, has_force, n)
        self.precision = 100
        self.step = 0
        self.time = 0.0
        self.lambda_ = 0.0
        self._device = None if device is None else as_device(device)
        self.labeled_atoms: dict[str, int] = {}
        self._traj_writers: dict = {}
        # reserved groups 'all' / 'All' (reference: system/mod.rs:156)
        self.groups: dict[str, Group] = {
            g: Group(AtomContainer.from_ranges([(0, n - 1)]), print_ndx=False)
            for g in ("all", "All")}

    @classmethod
    def new(cls, name: str, topology: Topology, simbox: SimBox | None = None,
            **kw) -> "System":
        return cls(name=name, topology=topology, simbox=simbox, **kw)

    # ------------------------------------------------------------ device
    @property
    def device(self) -> torch.device:
        """The device of the per-call methods: the CUDA card unless set to
        the CPU; resolved at the first call (raises without a card)."""
        if self._device is None:
            self._device = require_cuda()
        return self._device

    def set_device(self, device) -> None:
        """Compute on `device` ("cuda", "cuda:1" or "cpu") from now on."""
        self._device = as_device(device)

    # ------------------------------------------------------------ files
    @classmethod
    def from_file(cls, filename, device=None) -> "System":
        """Construct from a GRO, PDB or PQR file (reference:
        system/mod.rs:197); `device` as for the constructor."""
        return cls.from_file_with_format(filename, FileType.from_name(filename),
                                         device=device)

    @classmethod
    def from_file_with_format(cls, filename, filetype: FileType,
                              device=None) -> "System":
        """reference: system/mod.rs:226."""
        if filetype is FileType.GRO:
            from ..io.gro import read_gro as read
        elif filetype is FileType.PDB:
            from ..io.pdb import read_pdb as read
        elif filetype is FileType.PQR:
            from ..io.pqr import read_pqr as read
        elif filetype is FileType.TPR:
            raise FileTypeError(
                f"cannot construct a System from '{filename}': reading TPR "
                "files is not ported to groan_rs_tpu_torch yet (see ROADMAP.md)")
        else:
            raise FileTypeError(
                f"cannot construct a System from '{filename}' "
                f"(file type '{filetype.value}')")
        system = read(filename)
        if device is not None:
            system.set_device(device)
        return system

    def write_gro(self, filename, write_velocities: bool = False):
        from ..io.gro import write_gro

        write_gro(self, filename, "all", write_velocities)

    def group_write_gro(self, group: str, filename, write_velocities: bool = False):
        from ..io.gro import write_gro

        write_gro(self, filename, group, write_velocities)

    def write_pdb(self, filename, write_conect: bool = False):
        from ..io.pdb import write_pdb

        write_pdb(self, filename, "all", write_conect)

    def group_write_pdb(self, group: str, filename, write_conect: bool = False):
        from ..io.pdb import write_pdb

        write_pdb(self, filename, group, write_conect)

    def write_pqr(self, filename, precision=None):
        from ..io.pqr import write_pqr

        write_pqr(self, filename, precision, "all")

    def group_write_pqr(self, group: str, filename, precision=None):
        from ..io.pqr import write_pqr

        write_pqr(self, filename, precision, group)

    def add_bonds_from_pdb(self, filename):
        from ..io.pdb import add_bonds_from_pdb

        add_bonds_from_pdb(self, filename)

    def read_ndx(self, filename):
        """reference: ndx_io.rs:39."""
        from ..io.ndx import read_ndx

        read_ndx(self, filename)

    def read_ndx_with_default(self, filename, default: str):
        """Read ndx if it exists, else fall back to `default`
        (reference: utility.rs:26)."""
        if filename is not None and os.path.isfile(str(filename)):
            self.read_ndx(filename)
        elif default is not None and os.path.isfile(str(default)):
            self.read_ndx(default)

    def write_ndx(self, filename):
        from ..io.ndx import write_ndx

        write_ndx(self, filename)

    # ------------------------------------------------------------ state
    def get_name(self) -> str:
        return self.name

    def get_n_atoms(self) -> int:
        return self.topology.n_atoms

    def get_box(self) -> SimBox | None:
        return self.simbox

    def get_box_copy(self) -> SimBox | None:
        return None if self.simbox is None else SimBox(*iter(self.simbox))

    def set_box(self, simbox: SimBox | None) -> None:
        self.simbox = simbox

    def has_box(self) -> bool:
        return self.simbox is not None and not self.simbox.is_zero()

    def get_box_center(self) -> np.ndarray:
        sb = simbox_check(self.simbox)
        return np.array([sb.x / 2.0, sb.y / 2.0, sb.z / 2.0], dtype=np.float32)

    def box_lengths(self) -> np.ndarray:
        """`(3,)` float32 orthogonal box lengths (raises SimBoxError for a
        missing, triclinic or invalid box)."""
        return simbox_check(self.simbox).to_lengths_vec()

    def frame_state(self) -> dict:
        """The current frame as tensors on the System's device: positions
        `[N, 3]` and the box lengths `(3,)` (zeros without a box) float32,
        the step int32 and the time float32."""
        dev = self.device
        box = (self.simbox.to_lengths_vec() if self.simbox is not None
               else np.zeros(3, np.float32))
        return {
            "positions": torch.as_tensor(np.asarray(self.positions, np.float32),
                                         device=dev),
            "box": torch.as_tensor(box, device=dev),
            "step": torch.tensor(self.step, dtype=torch.int32, device=dev),
            "time": torch.tensor(self.time, dtype=torch.float32, device=dev),
        }

    def get_step(self) -> int:
        return self.step

    def set_step(self, v: int) -> None:
        self.step = int(v)

    def get_time(self) -> float:
        return self.time

    def set_time(self, v: float) -> None:
        self.time = float(v)

    def get_precision(self) -> int:
        return self.precision

    def set_precision(self, v: int) -> None:
        self.precision = int(v)

    def get_lambda(self) -> float:
        return self.lambda_

    def set_lambda(self, v: float) -> None:
        self.lambda_ = float(v)

    def get_mol_references(self) -> np.ndarray:
        return self.topology.mol_references()

    # ------------------------------------------------------------ atoms
    def get_atom(self, index: int) -> Atom:
        if not (0 <= index < self.topology.n_atoms):
            raise AtomError(f"atom index {index} out of range", code="OutOfRange")
        return Atom(self, index)

    get_atom_copy = get_atom

    def atoms_iter(self):
        """All atoms as a chainable AtomIterator (reference: iterating.rs
        atoms_iter; adaptors per iterators.rs:842,1053)."""
        from .iterating import AtomIterator

        return AtomIterator(self, np.arange(self.topology.n_atoms))

    atoms_iter_mut = atoms_iter

    # ------------------------------------------------------------ group queries
    def get_groups(self) -> dict:
        return self.groups

    def get_n_groups(self) -> int:
        return len(self.groups)

    def group_get_n_atoms(self, name: str) -> int:
        return self._get_group(name).get_n_atoms()

    def group_is_empty(self, name: str) -> bool:
        return self._get_group(name).get_n_atoms() == 0

    group_isempty = group_is_empty

    def group_isin(self, name: str, index: int) -> bool:
        return bool(np.isin(index, self.group_indices(name)))

    def group_mask(self, name: str) -> np.ndarray:
        """Boolean mask of a group over all atoms."""
        return self._get_group(name).atoms.mask(self.topology.n_atoms)

    def get_labeled_atoms(self) -> dict:
        return self.labeled_atoms

    # ------------------------------------------------------------ copies
    def copy(self) -> "System":
        """A System with copies of everything but the open writers."""
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new.topology = self.topology.copy()
        new.simbox = self.get_box_copy()
        for key in ("positions", "has_position", "velocities", "has_velocity",
                    "forces", "has_force"):
            setattr(new, key, getattr(self, key).copy())
        new.groups = self.get_groups_copy()
        new.labeled_atoms = dict(self.labeled_atoms)
        new._traj_writers = {}
        return new

    def _extract(self, indices, name: str) -> "System":
        """A new System of the atoms `indices` (reference analogue:
        System::new(name, system.group_extract(g), box), mod.rs:453,479)."""
        idx = np.asarray(indices, np.int64)
        new = System(name, self.topology.subset(idx), self.get_box_copy(),
                     device=self._device)
        for key in ("positions", "has_position", "velocities", "has_velocity",
                    "forces", "has_force"):
            setattr(new, key, getattr(self, key)[idx].copy())
        new.set_step(self.get_step())
        new.set_time(self.get_time())
        return new

    def group_extract(self, name: str) -> "System":
        """New System of the group's atoms, bonds among them renumbered
        (reference: System::group_extract, mod.rs:479)."""
        return self._extract(self.group_indices(name),
                             f"Group `{name}` extracted from {self.get_name()}")

    def atoms_extract(self) -> "System":
        """New System with copies of all atoms but no custom groups
        (reference: System::atoms_extract, mod.rs:453)."""
        return self._extract(np.arange(self.get_n_atoms()), self.get_name())

    # ------------------------------------------------------------ trajectories
    def xtc_iter(self, filename, **kw):
        from ..io.traj import xtc_iter

        return xtc_iter(self, filename, **kw)

    def trr_iter(self, filename, **kw):
        from ..io.traj import trr_iter

        return trr_iter(self, filename, **kw)

    def gro_iter(self, filename, **kw):
        from ..io.traj import gro_iter

        return gro_iter(self, filename, **kw)

    def tng_iter(self, filename, **kw):
        from ..io.traj import tng_iter

        return tng_iter(self, filename, **kw)

    def group_xtc_iter(self, group: str, filename, **kw):
        from ..io.traj import xtc_iter

        return xtc_iter(self, filename, group=group, **kw)

    def traj_iter(self, filename, **kw):
        from ..io.traj import traj_iter

        return traj_iter(self, filename, **kw)

    def xtc_cat_iter(self, filenames, **kw):
        from ..io.traj import cat_iter

        return cat_iter(self, filenames, fmt="xtc", **kw)

    def trr_cat_iter(self, filenames, **kw):
        from ..io.traj import cat_iter

        return cat_iter(self, filenames, fmt="trr", **kw)

    def traj_cat_iter(self, filenames, **kw):
        from ..io.traj import cat_iter

        return cat_iter(self, filenames, **kw)

    def group_traj_cat_iter(self, filenames, group, **kw):
        """Concatenated iteration over one group's atoms
        (reference: traj_cat.rs:399)."""
        from ..io.traj import cat_iter

        return cat_iter(self, filenames, group=group, **kw)

    def traj_iter_map_reduce(self, filenames, body, **kw):
        """Map-reduce over a trajectory on the System's device (the
        reference's System::traj_iter_map_reduce, parallel.rs:208)."""
        from ..parallel import traj_iter_map_reduce

        return traj_iter_map_reduce(self, filenames, body, **kw)

    traj_iter_cat_map_reduce = traj_iter_map_reduce

    # ------------------------------------------------------------ writers
    # reference: src/io/traj_write.rs (the writers registry of a System)
    def _writer(self, filename):
        key = str(filename)
        if key not in self._traj_writers:
            raise WriteTrajError(f"no writer for '{filename}'", code="WriterNotFound")
        return key

    def group_traj_writer_init(self, group, filename, fmt=None, **kw):
        """reference: traj_write.rs:154."""
        from ..io.traj import make_writer

        key = str(filename)
        if key in self._traj_writers:
            raise WriteTrajError(f"writer for '{filename}' already exists",
                                 code="WriterAlreadyExists")
        self._traj_writers[key] = make_writer(self, filename, group, fmt, **kw)

    def traj_writer_init(self, filename, fmt=None, **kw):
        """reference: traj_write.rs:121 (+ auto-format :174)."""
        self.group_traj_writer_init("all", filename, fmt, **kw)

    def traj_writer_auto_init(self, filename, **kw):
        self.traj_writer_init(filename, **kw)

    def traj_group_writer_init(self, group, filename, fmt=None, **kw):
        self.group_traj_writer_init(group, filename, fmt, **kw)

    def traj_group_writer_auto_init(self, group, filename, **kw):
        self.group_traj_writer_init(group, filename, **kw)

    def xtc_writer_init(self, filename, **kw):
        self.traj_writer_init(filename, fmt="xtc", **kw)

    def xtc_group_writer_init(self, group, filename, **kw):
        self.group_traj_writer_init(group, filename, fmt="xtc", **kw)

    def trr_writer_init(self, filename, **kw):
        self.traj_writer_init(filename, fmt="trr", **kw)

    def trr_group_writer_init(self, group, filename, **kw):
        self.group_traj_writer_init(group, filename, fmt="trr", **kw)

    def get_n_writers(self) -> int:
        return len(self._traj_writers)

    def traj_write_frame(self):
        """Write the current frame into every open writer
        (reference: traj_write.rs:235)."""
        for w in self._traj_writers.values():
            w.write_frame()

    def traj_write_frame_to_file(self, filename):
        self._traj_writers[self._writer(filename)].write_frame()

    def traj_writer_close(self, filename):
        """reference: traj_write.rs:257."""
        self._traj_writers.pop(self._writer(filename)).close()

    traj_close_file = traj_writer_close

    def traj_writers_close(self):
        """reference: traj_write.rs:246."""
        for w in self._traj_writers.values():
            w.close()
        self._traj_writers.clear()

    traj_close = traj_writers_close
