"""Time-correlation and transport analyses: MSD, diffusion, per-molecule
MSD, VACF, DOS, rotational ACF, conductivity, Van Hove, trajectory filter,
TCAF viscosity, dipole ACF and hydrogen-bond kinetics.

Port of `groan_rs_tpu/models/dynamics.py`.  Every device step is plain
torch on the System's device (the CUDA card unless the System was built or
set with `device="cpu"`), as the JAX functions are jnp outside any Pallas
kernel: no function here launches K1, K2 or K3.  The lag sweeps are
`ops.msd`; the fits, transforms and hydrogen-bond curves stay float64 host
numpy, as in the JAX package.  Results come back as numpy in the JAX
functions' keys, shapes and units.  Every name is importable as
`groan_rs_tpu_torch.models.<name>` and `models.pipeline.<name>`.

Where the port differs on purpose:
- `vanhove` counts in int64 (`torch.bincount`); the JAX function adds
  float32 ones, which stop counting past 2^24 in one shell.
- `msd_mol` sums the molecule COMs with `index_put_(accumulate=True)`,
  which sums in a fixed order on CUDA (`index_add_`'s float atomics would
  not), so repeated calls give the same bits.
- The lag sums run over the valid origins only (`ops.msd.lag_sums`).
- The trapezoids are written out as numpy's `trapezoid` computes them
  (`_trapezoid`), which exists only from numpy 2.0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import GroupError, ParallelError
from ..ops import msd as msd_ops
from ..ops import pbc
from .pipeline import (
    TrajectoryAnalysis,
    _AMU_NM_PS_TO_PAS,
    _BOLTZ,
    _blocks_by_key,
    _f32,
    _group_frames,
    _named_group,
    _resident_group_cols,
    _resident_group_pos,
    _sel_indices,
    _system_triclinic,
    _transient_indices,
    _unit_tables,
    _window_pos,
)

__all__ = ["msd", "vacf", "diffusion", "msd_mol", "dos", "hbond_acf",
           "hbond_lifetime", "rotacf", "current", "vanhove", "filter_traj",
           "tcaf", "dipole_corr"]


def _trapezoid(y, x) -> float:
    """`np.trapezoid(y, x)` as numpy computes it, on any numpy version."""
    y = np.asarray(y, np.float64)
    return float((np.diff(np.asarray(x, np.float64)) * (y[1:] + y[:-1]) / 2.0).sum())


def _check_lags(lags, f):
    lags = np.arange(f, dtype=np.int64) if lags is None else np.asarray(lags, np.int64)
    if len(lags) and (lags.min() < 0 or lags.max() >= f):
        raise ParallelError(f"lags must lie in [0, {f}) (trajectory has {f} frames)")
    return lags


def _axis_mask(dims):
    if (not dims or any(c not in "xyz" for c in dims)
            or len(set(dims)) != len(dims)):
        raise ParallelError(f"dims must be a non-empty subset of 'xyz', got '{dims}'")
    return None if set(dims) == set("xyz") else np.array(
        [float(c in dims) for c in "xyz"], np.float32)


def _fit_range(fit_range):
    lo, hi = float(fit_range[0]), float(fit_range[1])
    if not (0.0 <= lo < hi <= 1.0):
        raise ParallelError(
            f"fit_range must satisfy 0 <= begin < end <= 1, got {fit_range}")
    return lo, hi


def _fit_mask(t, lo, hi, what="MSD points"):
    tmax = t[-1] if len(t) else 0.0
    mask = (t >= lo * tmax) & (t <= hi * tmax)
    if int(mask.sum()) < 2:
        raise ParallelError(
            f"fit window selects fewer than 2 {what}; widen fit_range or use "
            "a longer trajectory")
    return mask


def _velocity_window(system, trajectory, group, gsel, batch_size, missing):
    """The group's window with its velocity channel -> (DeviceTrajectory,
    columns, `[F, K, 3]` velocities on the System's device)."""
    from ..parallel.engine import DeviceTrajectory

    if isinstance(trajectory, DeviceTrajectory):
        dt = trajectory
        cols = _resident_group_cols(system, dt, group, gsel)
    else:
        runner = TrajectoryAnalysis(
            system, device=system.device, triclinic=_system_triclinic(system)
        ).runner(group=group, velocities=True)
        dt = runner.load_device(trajectory, batch_size=batch_size)
        cols = np.arange(len(gsel))
    if "vel" not in dt.aux_names:
        raise ParallelError(missing)
    vel = dt.aux[dt.aux_names.index("vel")]
    j = torch.as_tensor(np.asarray(cols), dtype=torch.int64, device=vel.device)
    return dt, cols, vel.index_select(1, j).to(system.device)


def _fetch(x) -> np.ndarray:
    return x.cpu().numpy()


def msd(system, trajectory, group: str, *, lags=None, dims: str = "xyz",
        batch_size: int = 32):
    """Mean-squared displacement of a selection over frame lags (`gmx msd`:
    atom-averaged, all time origins); `dims` restricts the displacement to
    a subset of axes ("xy" = -lateral z).  `trajectory` is a filename
    (loaded once, shipping only the group) or a DeviceTrajectory whose
    layout holds the group.  Triclinic systems unwrap through the exact
    minimum image.  Returns `(lag_times [L] ps, msd [L] nm^2)`; `lags`
    defaults to every lag 0..F-1."""
    gsel = np.asarray(system.group_indices(group))
    if gsel.size == 0:
        raise GroupError(f"group '{group}' is empty", code="EmptyGroup")
    dt, cols = _group_frames(system, trajectory, group, gsel, batch_size)
    f = int(dt.pos.shape[0])
    lags = _check_lags(lags, f)
    pos, boxes = _window_pos(dt, cols, system.device)
    am = _axis_mask(dims)
    u = msd_ops.unwrap(pos, boxes)
    curve = _fetch(msd_ops.msd_lags(u, lags, axis_mask=am))
    times = np.asarray(dt.times, np.float64)
    return times[lags] - times[0], curve


def vacf(system, trajectory, group: str, *, lags=None, mass_weighted=False,
         batch_size: int = 32):
    """Velocity autocorrelation of a selection over frame lags (`gmx
    velacc`: <v(t) . v(t + tau)> over origins and atoms, mass-weighted with
    `mass_weighted=True`).  `trajectory` is a TRR filename (loaded with the
    velocity channel, shipping only the group) or a DeviceTrajectory with a
    'vel' channel.  Returns `(lag_times [L] ps, vacf [L] (nm/ps)^2)`."""
    gsel = np.asarray(system.group_indices(group))
    if gsel.size == 0:
        raise GroupError(f"group '{group}' is empty", code="EmptyGroup")
    dt, _, v = _velocity_window(
        system, trajectory, group, gsel, batch_size,
        "the DeviceTrajectory carries no velocity channel; load it "
        "with runner(velocities=True).load_device(...)")
    f = int(v.shape[0])
    lags = _check_lags(lags, f)
    w = None
    if mass_weighted:
        if not system.topology.has_mass[gsel].all():
            raise GroupError(f"group '{group}' has atoms without mass", code="InvalidMass")
        w = np.asarray(system.topology.mass, np.float32)[gsel]
    curve = _fetch(msd_ops.lag_correlation(v, lags, weights=w))
    times = np.asarray(dt.times, np.float64)
    return times[lags] - times[0], curve


def diffusion(system, trajectory, group: str, *, fit_range=(0.1, 0.9),
              dims: str = "xyz", batch_size: int = 32):
    """Self-diffusion coefficient from the Einstein relation (`gmx msd`
    -beginfit/-endfit): the float64 least-squares slope of `msd` over
    `fit_range` fractions of the largest lag time, over 2 * len(dims).
    Returns a dict: 'D' (cm^2/s), 'D_1e5', 'slope' (nm^2/ps), 'intercept'
    (nm^2), 'lag_times' [L], 'msd' [L], 'fit_mask' [L]."""
    lo, hi = _fit_range(fit_range)
    lag_times, curve = msd(system, trajectory, group, dims=dims, batch_size=batch_size)
    t = np.asarray(lag_times, np.float64)
    y = np.asarray(curve, np.float64)
    mask = _fit_mask(t, lo, hi)
    a = np.stack([t[mask], np.ones(int(mask.sum()))], axis=1)
    (slope, intercept), *_ = np.linalg.lstsq(a, y[mask], rcond=None)
    d_nm2_ps = slope / (2.0 * len(set(dims)))
    return {"D": d_nm2_ps * 1e-2, "D_1e5": d_nm2_ps * 1e3,
            "slope": float(slope), "intercept": float(intercept),
            "lag_times": t, "msd": y, "fit_mask": mask}


def msd_mol(system, trajectory, group: str, *, fit_range=(0.1, 0.9),
            dims: str = "xyz", lags=None, batch_size: int = 32):
    """Per-molecule centre-of-mass MSD and diffusion coefficients (`gmx msd
    -mol`).  Molecules are the bond-graph components of `group`; atom paths
    are unwrapped first, then the (mass-weighted, where the topology has
    masses) COMs of the continuous paths are summed per molecule in a fixed
    order, and each molecule's D comes from one vectorised float64 fit.
    Returns a dict: 'n_molecules', 'first_atom' [M], 'lag_times' [L],
    'msd' [L, M], 'msd_mean' [L], 'D' [M] (cm^2/s), 'D_1e5' [M], 'D_mean',
    'D_std', 'fit_mask' [L]."""
    lo, hi = _fit_range(fit_range)
    am = _axis_mask(dims)
    gsel, pos, boxes, dt = _resident_group_pos(system, trajectory, group, batch_size)

    mol = np.asarray(system.topology.molecule_ids())[gsel]
    _, first_local, inv = np.unique(mol, return_index=True, return_inverse=True)
    m = int(first_local.shape[0])
    topo = system.topology
    if np.asarray(topo.has_mass)[gsel].all():
        wts = np.asarray(topo.mass, np.float64)[gsel]
    else:
        wts = np.ones(gsel.shape[0], np.float64)
    wsum = np.zeros(m, np.float64)
    np.add.at(wsum, inv, wts)

    f = int(pos.shape[0])
    lags = np.arange(f, dtype=np.int64) if lags is None else np.asarray(lags, np.int64)
    if len(lags) == 0 or lags.min() < 0 or lags.max() >= f:
        raise ParallelError(f"lags must be non-empty and lie in [0, {f})")

    dev = pos.device
    seg = torch.as_tensor(inv.reshape(-1), dtype=torch.int64, device=dev)
    w32 = torch.as_tensor((wts / wsum[inv.reshape(-1)]).astype(np.float32), device=dev)
    u = msd_ops.unwrap(pos, boxes)
    terms = (u * w32[None, :, None]).transpose(0, 1).contiguous()   # [K, F, 3]
    com = torch.zeros((m, f, 3), dtype=torch.float32, device=dev)
    com.index_put_((seg,), terms, accumulate=True)
    del u, terms
    curves = _fetch(msd_ops.msd_lags_per_entity(
        com.transpose(0, 1), lags, axis_mask=am)).astype(np.float64)   # [L, M]

    times = np.asarray(dt.times, np.float64)
    t = times[lags] - times[0]
    mask = _fit_mask(t, lo, hi)
    a = np.stack([t[mask], np.ones(int(mask.sum()))], axis=1)
    coef, *_ = np.linalg.lstsq(a, curves[mask], rcond=None)     # [2, M]
    d_nm2_ps = coef[0] / (2.0 * len(set(dims)))
    d_cm2_s = d_nm2_ps * 1e-2
    return {"n_molecules": m, "first_atom": gsel[first_local],
            "lag_times": t, "msd": curves, "msd_mean": curves.mean(axis=1),
            "D": d_cm2_s, "D_1e5": d_nm2_ps * 1e3,
            "D_mean": float(d_cm2_s.mean()),
            "D_std": float(d_cm2_s.std(ddof=1)) if m > 1 else 0.0,
            "fit_mask": mask}


def dos(system, trajectory, group: str, *, temperature: float | None = None,
        batch_size: int = 32):
    """Vibrational density of states from the mass-weighted VACF (`gmx
    dos`): S(nu) = (2 / (kB T)) FT[C](nu), C(t) = sum_i m_i <v_i(0).v_i(t)>.
    The VACFs run on the device (`vacf`), the even extension, rFFT and
    Parseval sums in float64 numpy; T defaults to C(0) / (3 N kB), and D is
    the Green-Kubo integral of the unweighted VACF over 3.  Returns a dict:
    'nu', 'dos', 'vacf_times', 'vacf', 'T', 'D' (cm^2/s), 'dof', 'n_atoms'."""
    from ..parallel.engine import DeviceTrajectory

    gsel = np.asarray(system.group_indices(group))
    n = int(gsel.size)
    if n == 0:
        raise GroupError(f"group '{group}' is empty", code="EmptyGroup")
    if not system.topology.has_mass[gsel].all():
        raise GroupError(f"group '{group}' has atoms without mass", code="InvalidMass")
    m_total = float(np.asarray(system.topology.mass, np.float64)[gsel].sum())

    dt_obj = trajectory
    if not isinstance(dt_obj, DeviceTrajectory):
        runner = TrajectoryAnalysis(
            system, device=system.device, triclinic=_system_triclinic(system)
        ).runner(group=group, velocities=True)
        dt_obj = runner.load_device(trajectory, batch_size=batch_size)
    times, c_w = vacf(system, dt_obj, group, mass_weighted=True)
    _, c_u = vacf(system, dt_obj, group, mass_weighted=False)

    t = np.asarray(times, np.float64)
    c_total = np.asarray(c_w, np.float64) * m_total
    length = len(t)
    if length < 3:
        raise ParallelError("dos needs at least 3 frames of velocities")
    dt_ps = float(t[1] - t[0])
    if dt_ps <= 0 or not np.allclose(np.diff(t), dt_ps, rtol=1e-3):
        raise ParallelError(
            "dos requires a uniform frame-time grid; resample the "
            "trajectory with with_step/with_range first")

    kb = _BOLTZ
    if temperature is None:
        temperature = c_total[0] / (3.0 * n * kb)
    temperature = float(temperature)
    if temperature <= 0:
        raise ParallelError("temperature must be positive")

    ext = np.concatenate([c_total, c_total[-2:0:-1]])
    m_ext = len(ext)
    spec = np.fft.rfft(ext).real * dt_ps
    s_nu = (2.0 / (kb * temperature)) * spec
    nu = np.fft.rfftfreq(m_ext, d=dt_ps)
    dnu = 1.0 / (m_ext * dt_ps)
    dof = float((s_nu.sum() - 0.5 * (s_nu[0] + s_nu[-1])) * dnu)

    d_nm2_ps = _trapezoid(c_u, t) / 3.0
    return {"nu": nu, "dos": s_nu, "vacf_times": t, "vacf": c_total,
            "T": temperature, "D": d_nm2_ps * 1e-2, "dof": dof, "n_atoms": n}


def hbond_acf(system, trajectory, chains, pairs, *,
              max_distance: float = 0.35, min_angle: float = 120.0,
              continuous: bool = False, batch_size: int = 16,
              start_time=None, end_time=None, step=None):
    """Hydrogen-bond existence autocorrelation (`gmx hbond -ac`): bonds
    detected per frame by `hbonds_analyze_batched` on the System's device,
    identified by (pair, donor, hydrogen, acceptor); C(tau) = <h(t) h(t +
    tau)> / <h> (intermittent), or with `continuous=True` only bonds that
    persist through every frame between.  Returns `(lag_times, curve)`."""
    times, h = _hbond_h_matrix(system, trajectory, chains, pairs, max_distance,
                               min_angle, batch_size, what="hbond_acf",
                               start_time=start_time, end_time=end_time, step=step)
    return np.asarray(times, np.float64) - times[0], _hbond_curve(h, continuous)


def _hbond_h_matrix(system, trajectory, chains, pairs, max_distance,
                    min_angle, batch_size, what,
                    start_time=None, end_time=None, step=None, keys=None):
    """Shared detection pass: per-frame bond existence matrix [F, P].  A
    dict passed as `keys` receives each bond's column, by (pair, donor,
    hydrogen, acceptor)."""
    times, frames = [], []
    seen: dict[tuple, int] = {} if keys is None else keys
    for time, hmap in system.hbonds_analyze_batched(
            trajectory, chains, pairs, max_distance, min_angle,
            batch_size=batch_size, device=system.device, start_time=start_time,
            end_time=end_time, step=step):
        times.append(time)
        ids = []
        for pk, bonds in hmap.items():
            for b in bonds:
                key = (pk, b.donor, b.hydrogen, b.acceptor)
                if key not in seen:
                    seen[key] = len(seen)
                ids.append(seen[key])
        frames.append(np.asarray(ids, np.int64))
    f = len(frames)
    if f < 2:
        raise ParallelError(f"{what} needs at least 2 frames (trajectory has {f})")
    if len(seen) == 0:
        raise ParallelError("no hydrogen bonds found in the trajectory")
    h = np.zeros((f, len(seen)), bool)
    for t, ids in enumerate(frames):
        h[t, ids] = True
    return times, h


def _hbond_curve(h, continuous):
    f = h.shape[0]
    mean_h = h.mean()
    curve = np.empty(f)
    if continuous:
        # run[t, p] = length of the 1-run starting at t
        run = np.zeros((f + 1, h.shape[1]), np.int64)
        for t in range(f - 1, -1, -1):
            run[t] = np.where(h[t], run[t + 1] + 1, 0)
        for tau in range(f):
            curve[tau] = (run[: f - tau] >= tau + 1).mean() / mean_h
    else:
        for tau in range(f):
            curve[tau] = (h[: f - tau] & h[tau:]).mean() / mean_h
    return curve


def hbond_lifetime(system, trajectory, chains, pairs, *,
                   max_distance: float = 0.35, min_angle: float = 120.0,
                   batch_size: int = 16,
                   start_time=None, end_time=None, step=None):
    """Hydrogen-bond lifetimes (`gmx hbond -life` / `-ac`): one detection
    pass, the intermittent and continuous curves and their trapezoid
    integrals; 'k_rapaport' = 1 / tau_continuous ('k_forward' its alias).
    Returns a dict: 'lag_times', 'intermittent', 'continuous',
    'tau_intermittent', 'tau_continuous', 'k_rapaport', 'k_forward',
    'n_bonds_seen', 'occupancy'."""
    times, h = _hbond_h_matrix(system, trajectory, chains, pairs, max_distance,
                               min_angle, batch_size, what="hbond_lifetime",
                               start_time=start_time, end_time=end_time, step=step)
    lag_times = np.asarray(times, np.float64) - times[0]
    ci = _hbond_curve(h, continuous=False)
    cc = _hbond_curve(h, continuous=True)
    tau_i = _trapezoid(ci, lag_times)
    tau_c = _trapezoid(cc, lag_times)
    k_rap = (1.0 / tau_c) if tau_c > 0 else float("inf")
    return {"lag_times": lag_times, "intermittent": ci, "continuous": cc,
            "tau_intermittent": tau_i, "tau_continuous": tau_c,
            "k_rapaport": k_rap, "k_forward": k_rap,
            "n_bonds_seen": int(h.shape[1]), "occupancy": float(h.mean())}


def rotacf(system, trajectory, pairs, *, order: int = 2, lags=None,
           batch_size: int = 32):
    """Rotational autocorrelation of axis vectors (`gmx rotacf -P {1,2}`):
    `pairs` `[K, 2]` atom indices, u the unit minimum-image vector from
    pairs[:, 1] to pairs[:, 0]; C_n(tau) = <P_n(u(t) . u(t + tau))> over
    origins and vectors.  Only the pairs' atoms are loaded.  Returns
    `(lag_times [L], curve [L])`."""
    from ..parallel.engine import DeviceTrajectory

    pairs = np.asarray(pairs, np.int64)
    if pairs.ndim != 2 or pairs.shape[1] != 2 or pairs.shape[0] == 0:
        raise GroupError("pairs must be a non-empty [K, 2] array of atom indices",
                         code="InvalidSelection")
    n = int(system.get_n_atoms())
    if pairs.min() < 0 or pairs.max() >= n:
        raise GroupError(f"pairs reference atoms outside 0..{n - 1}",
                         code="AtomOutOfRange")
    if order not in (1, 2):
        raise GroupError("order must be 1 or 2", code="InvalidMode")

    if isinstance(trajectory, DeviceTrajectory):
        dt = trajectory
        sel = np.arange(n) if dt.sel is None else np.asarray(dt.sel)
    else:
        tag = "__rotacf__"
        sel = np.unique(pairs.ravel())
        system.group_create_from_indices(tag, sel)
        try:
            runner = TrajectoryAnalysis(
                system, device=system.device,
                triclinic=_system_triclinic(system)).runner(group=tag)
            dt = runner.load_device(trajectory, batch_size=batch_size)
        finally:
            system.group_remove(tag)
    lut = np.full(n, -1, np.int64)
    lut[sel] = np.arange(sel.shape[0])
    cols = lut[pairs]
    if (cols < 0).any():
        raise ParallelError(
            "the DeviceTrajectory's layout does not contain every "
            "pair atom; reload with a wider selection")

    f = int(dt.pos.shape[0])
    lags = _check_lags(lags, f)
    head, boxes = _window_pos(dt, cols[:, 0], system.device)
    tail, _ = _window_pos(dt, cols[:, 1], system.device)
    d = pbc.min_image_frames_any(head - tail, boxes)
    u = d / torch.sqrt(pbc.norm2(d))[..., None]
    curve = _fetch(msd_ops.legendre_lag_correlation(u, lags, order))
    times = np.asarray(dt.times, np.float64)
    return times[lags] - times[0], curve


def _dipole_path(u, q):
    """M_J(t) = sum_i q_i u_i(t), float32, in frame chunks whose product
    stays within 2^26 elements -> `[F, 3]`."""
    step = max(1, (1 << 26) // max(1, u[0].numel()))
    return torch.cat([(u[a:a + step] * q[None, :, None]).sum(1)
                      for a in range(0, u.shape[0], step)])


def current(system, trajectory, group: str = "all", *,
            temperature: float = 300.0, fit_range=(0.1, 0.5), lags=None,
            batch_size: int = 32):
    """Ionic conductivity from the Einstein-Helfand translational dipole
    (`gmx current`): M_J(t) = sum_i q_i u_i(t) over the group's unwrapped
    positions, sigma = slope of <|M_J(t0 + t) - M_J(t0)|^2> / (6 V kB T)
    fitted in float64 over `fit_range` fractions of the largest lag, V the
    mean box volume.  Returns a dict: 'conductivity' (S/m), 'slope' (e^2
    nm^2/ps), 'lag_times', 'mj2' (e^2 nm^2), 'fit_mask', 'volume' (nm^3),
    'net_charge' (e)."""
    lo, hi = _fit_range(fit_range)
    if not temperature > 0:
        raise ParallelError("temperature must be positive")

    gsel, pos, boxes, dt_obj = _resident_group_pos(system, trajectory, group, batch_size)
    topo = system.topology
    if not topo.has_charge[gsel].all():
        raise GroupError(f"group '{group}' has atoms without charge", code="InvalidCharge")
    q = np.asarray(topo.charge, np.float64)[gsel]

    f = int(pos.shape[0])
    lags = np.arange(f, dtype=np.int64) if lags is None else np.asarray(lags, np.int64)
    if len(lags) < 3 or lags.min() < 0 or lags.max() >= f:
        raise ParallelError(f"need >= 3 lags inside [0, {f}) (trajectory has {f} frames)")

    u = msd_ops.unwrap(pos, boxes)
    mj = _dipole_path(u, torch.as_tensor(q.astype(np.float32), device=u.device))
    curve = _fetch(msd_ops.msd_lags(mj[:, None, :], lags)).astype(np.float64)

    times = np.asarray(dt_obj.times, np.float64)
    t = times[lags] - times[0]
    tmax = t[-1]
    mask = (t >= lo * tmax) & (t <= hi * tmax) & (t > 0)
    if int(mask.sum()) < 2:
        raise ParallelError(
            "fit window selects fewer than 2 points; widen fit_range or "
            "use a longer trajectory")
    a = np.stack([t[mask], np.ones(int(mask.sum()))], axis=1)
    (slope, _icept), *_ = np.linalg.lstsq(a, curve[mask], rcond=None)

    bx = _fetch(boxes).astype(np.float64)
    vol = float((np.abs(np.linalg.det(bx)) if bx.ndim == 3
                 else np.prod(bx, axis=1)).mean())
    e_c = 1.602176634e-19          # C
    kb_j = 1.380649e-23            # J/K
    # e^2 nm^2/ps -> C^2 m^2/s ; V nm^3 -> m^3
    si = float(slope) * e_c ** 2 * 1e-18 / 1e-12
    sigma = si / (6.0 * kb_j * float(temperature) * vol * 1e-27)
    return {"conductivity": sigma, "slope": float(slope),
            "lag_times": t, "mj2": curve, "fit_mask": mask,
            "volume": vol, "net_charge": float(q.sum())}


def vanhove(system, trajectory, group: str, *, lags=None, r_max: float = 2.0,
            bins: int = 100, batch_size: int = 32):
    """Self part of the Van Hove function Gs(r, t) (`gmx vanhove -or`): for
    each lag the displacement magnitudes of the unwrapped paths over every
    origin and atom, counted in int64 into `bins` shells of r_max / bins
    (at or past r_max: the overflow bin); Gs integrates to 1 when nothing
    overflows.  `lags` default 1..min(F - 1, 50).  Returns a dict: 'r'
    [bins], 'lags' [L], 'gs' [L, bins], 'counts' [L, bins] int64,
    'overflow' [L] (the fraction past r_max)."""
    _, pos, boxes, _ = _resident_group_pos(system, trajectory, group, batch_size)
    f = int(pos.shape[0])
    if f < 2:
        raise ParallelError("vanhove needs at least 2 frames")
    if lags is None:
        lags = range(1, min(f, 51))
    lags = np.asarray(sorted(set(int(x) for x in lags)), np.int32)
    if lags.size == 0 or lags[0] < 1 or lags[-1] >= f:
        raise ParallelError(f"lags must be within [1, {f - 1}], got {lags.tolist()}")
    dr = float(r_max) / bins
    dr_t, rmax_t = _f32(dr, pos.device), _f32(r_max, pos.device)

    def chunk(a, b):
        norm = torch.sqrt(pbc.norm2(a - b))
        idx = torch.clamp((norm / dr_t).to(torch.int64), 0, bins)
        idx = torch.where(norm >= rmax_t, bins, idx)
        return torch.bincount(idx.reshape(-1), minlength=bins + 1)

    u = msd_ops.unwrap(pos, boxes)
    h = _fetch(msd_ops.lag_sums(u, lags, chunk, shape=(bins + 1,), dtype=torch.int64))
    counts = h[:, :bins]
    overflow = h[:, bins].astype(np.float64)
    total = counts.sum(axis=1) + overflow
    gs = counts / (total[:, None] * dr)
    r = (np.arange(bins) + 0.5) * dr
    return {"r": r, "lags": lags, "gs": gs, "counts": counts,
            "overflow": overflow / np.maximum(total, 1.0)}


def filter_traj(system, trajectory, output, *, window: int = 5,
                group: str = "all", wrap: bool = False, batch_size: int = 32):
    """Low-pass filter a trajectory with a cosine window and write the
    smoothed frames (`gmx filter -ol`): the unwrapped positions times one
    `[F, F]` band matrix (weights 1 + cos(pi i / (n + 1)), rows
    renormalised at the edges), a float32 `torch.matmul`; `wrap=True`
    rewraps into each frame's box.  Writes `output` (xtc/trr/gro by
    extension) and returns the number of frames written."""
    from ..core.simbox import SimBox

    if window < 1 or window % 2 == 0:
        raise ParallelError(f"window must be a positive odd frame count, got {window}")

    gsel, pos, boxes, dt = _resident_group_pos(system, trajectory, group, batch_size)
    f, k = int(pos.shape[0]), int(pos.shape[1])
    half = window // 2
    i = np.arange(f)
    off = np.arange(-half, half + 1)
    wts = 1.0 + np.cos(np.pi * off / (half + 1))
    band = np.zeros((f, f), np.float32)
    for o, wv in zip(off, wts):
        j = i + o
        ok = (j >= 0) & (j < f)
        band[i[ok], j[ok]] = wv
    band /= band.sum(axis=1, keepdims=True)

    u = msd_ops.unwrap(pos, boxes)
    sm = torch.matmul(torch.as_tensor(band, device=u.device),
                      u.reshape(f, 3 * k)).reshape(f, k, 3)
    if wrap:
        if boxes.dim() == 3:
            sm = pbc.wrap_triclinic_frames(sm, boxes)
        else:
            b = boxes[:, None, :]
            sm = sm - b * torch.floor(sm / b)
    sm = _fetch(sm)

    sub = system.group_extract(group) if group != "all" else system.atoms_extract()
    sub.traj_writer_init(output)
    boxes_np = _fetch(boxes)
    times = np.asarray(dt.times, np.float64)
    for fi in range(f):
        sub.positions[:] = sm[fi]
        sub.simbox = (SimBox.from_matrix(boxes_np[fi]) if boxes_np.ndim == 3
                      else SimBox.from_lengths(*map(float, boxes_np[fi])))
        sub.set_time(float(times[fi]))
        sub.set_step(fi)
        sub.traj_write_frame()
    sub.traj_writers_close()
    return f


def _transverse_currents(pos, vel, w, kmat):
    """`[F, 3 axes, n_k, 2 transverse, 2 (re, im)]` mass-weighted
    transverse currents sum_i m_i v_ib exp(i k x_ia), b != a, in frame
    chunks whose `[F, K, n_k]` phase stays within 2^26 elements."""
    f, k = pos.shape[0], pos.shape[1]
    step = max(1, (1 << 26) // max(1, k * kmat.shape[1]))
    out = []
    for c in range(0, f, step):
        p, v = pos[c:c + step], vel[c:c + step]
        axes = []
        for a in range(3):
            phase = p[:, :, a][:, :, None] * kmat[a][None, None, :]
            cosp = torch.cos(phase) * w[None, :, None]      # [F, K, n_k]
            sinp = torch.sin(phase) * w[None, :, None]
            per_axis = []
            for b in (b for b in range(3) if b != a):
                vb = v[:, :, b]
                re = torch.einsum("fk,fkm->fm", vb, cosp)
                im = torch.einsum("fk,fkm->fm", vb, sinp)
                per_axis.append(torch.stack([re, im], -1))
            axes.append(torch.stack(per_axis, 2))           # [F, n_k, 2, 2]
        out.append(torch.stack(axes, 1))
    return torch.cat(out)


def tcaf(system, trajectory, group: str = "all", *, n_k: int = 4,
         fit_floor: float = 0.3, batch_size: int = 32):
    """Shear viscosity from transverse-current autocorrelations (`gmx
    tcaf`): per axis a and mode m, k = 2 pi m / L_a; the transverse
    currents on the device, their all-origin ACF as one lag sweep, the
    curves averaged over the transverse components and axes; nu(k) from a
    float64 fit of ln C over the prefix above `fit_floor` * C(0), eta(k) =
    rho nu(k), eta0 from eta(k) = eta0 (1 - a k^2).  Needs velocities on a
    uniform time grid and a constant orthorhombic box.  Returns a dict:
    'k' [n_k], 'lag_times' [L], 'tcaf' [n_k, L] normalised, 'nu' [n_k]
    (nm^2/ps), 'eta_k' [n_k] (Pa s), 'eta0' (Pa s), 'rho' (amu/nm^3)."""
    gsel = np.asarray(_sel_indices(system, group))
    if gsel.size == 0:
        raise GroupError(f"group '{group}' is empty", code="EmptyGroup")
    dt, cols, vel = _velocity_window(
        system, trajectory, group, gsel, batch_size,
        "tcaf needs a velocity channel; load the trajectory with "
        "runner(velocities=True).load_device(...)")
    if not system.topology.has_mass[gsel].all():
        raise GroupError(f"group '{group}' has atoms without mass", code="InvalidMass")

    boxes = _fetch(dt.boxes).astype(np.float64)
    if boxes.ndim != 2:
        raise ParallelError(
            "tcaf supports orthorhombic boxes: its k vectors are "
            "2 pi m / L_a along the cartesian axes, which are only "
            "reciprocal-lattice vectors (periodic modes) for a "
            "rectangular cell; a sheared cell needs k = 2 pi m * "
            "rows(H^-T), which changes the published per-axis "
            "k-averaging convention — run on an orthorhombic box")
    box = boxes[0]
    if not np.allclose(boxes, box[None, :], rtol=1e-5):
        raise ParallelError(
            "tcaf needs a constant box (k vectors are box-fixed); "
            "this trajectory's box fluctuates")
    t = np.asarray(dt.times, np.float64)
    f = len(t)
    if f < 4:
        raise ParallelError("tcaf needs at least 4 frames")
    dt_ps = float(t[1] - t[0])
    if dt_ps <= 0 or not np.allclose(np.diff(t), dt_ps, rtol=1e-3):
        raise ParallelError(
            "tcaf requires a uniform frame-time grid; resample with "
            "with_step/with_range first")

    pos, _ = _window_pos(dt, cols, system.device)
    mass = np.asarray(system.topology.mass, np.float64)[gsel]
    w = torch.as_tensor(mass.astype(np.float32), device=pos.device)
    ks = np.stack([2.0 * np.pi * np.arange(1, n_k + 1) / box[a] for a in range(3)])
    j = _transverse_currents(pos, vel, w, torch.as_tensor(ks.astype(np.float32),
                                                          device=pos.device))
    series = j.reshape(f, -1)                                  # [F, S]
    acf = msd_ops.lag_sums(series, range(f), lambda a, b: (a * b).sum(0),
                           shape=(series.shape[1],))
    acf = _fetch(acf / msd_ops.origin_counts(f, range(f), pos.device)[:, None])
    # Re(j j*) = re.re + im.im: sum the (re, im) channel, average the
    # 2 transverse components and 3 axes
    c = acf.astype(np.float64).reshape(f, 3, n_k, 2, 2).sum(axis=-1).mean(axis=(1, 3)).T

    c0 = c[:, 0]
    if (c0 <= 0).any():
        raise ParallelError("tcaf found a zero-power mode; more frames "
                            "or a smaller n_k needed")
    cn = c / c0[:, None]
    lag_times = t - t[0]
    kmean = ks.mean(axis=0)
    k2 = kmean ** 2
    nu = np.empty(n_k)
    for m in range(n_k):
        good = cn[m] > fit_floor
        stop = int(np.argmin(good)) if not good.all() else f
        stop = max(stop, 3)
        x = lag_times[:stop]
        y = np.log(np.maximum(cn[m, :stop], 1e-12))
        a = np.stack([x, np.ones_like(x)], axis=1)
        (slope, _), *_ = np.linalg.lstsq(a, y, rcond=None)
        nu[m] = -slope / k2[m]

    rho = float(mass.sum() / box.prod())
    eta_k = rho * nu * _AMU_NM_PS_TO_PAS
    a = np.stack([np.ones(n_k), k2], axis=1)
    (eta0, _), *_ = np.linalg.lstsq(a, eta_k, rcond=None)
    return {"k": kmean, "lag_times": lag_times, "tcaf": cn, "nu": nu,
            "eta_k": eta_k, "eta0": float(eta0), "rho": rho}


def _molecular_dipoles(pos, boxes, cols, w, qt):
    """`[F, U, 3]` molecular dipoles about each unit's mass-weighted COM:
    sites `cols` `[U, P]` relative to the unit's first site through the
    minimum image (`min_image` for lengths, the exact triclinic search for
    matrices), in frame chunks of at most 2^26 site coordinates."""
    f = pos.shape[0]
    step = max(1, (1 << 26) // max(1, cols.numel() * 3))
    out = []
    for a in range(0, f, step):
        x = pos[a:a + step][:, cols]                        # [c, U, P, 3]
        bx = boxes[a:a + step]
        d0 = x - x[:, :, :1]
        if bx.dim() == 3:
            rel = pbc.min_image_triclinic_frames(
                d0.reshape(d0.shape[0], -1, 3), bx).reshape(d0.shape)
        else:
            rel = pbc.min_image(d0, bx[:, None, None, :])
        com_rel = (w[..., None] * rel).sum(2)
        out.append((qt[..., None] * (rel - com_rel[:, :, None, :])).sum(2))
    return torch.cat(out)


def dipole_corr(system, trajectory, group: str = "all", *,
                mode: str = "total", lags=None, batch_size: int = 32):
    """Dipole autocorrelation functions (`gmx dipoles -corr tot|mol`).
    mode='total': C(tau) = <M(t) . M(t + tau)>, M the per-frame total
    dipole of a runner pass (`add_total_dipole`).  mode='mol': molecular
    dipoles about each molecule's own mass-weighted COM, averaged over
    molecules and origins.  Returns a dict: 'lag_times' [L] ps, 'corr' [L]
    e^2 nm^2, 'phi' [L] (corr / corr[0]), 'corr_time' ps (trapezoid of phi
    up to its first zero crossing)."""
    if mode not in ("total", "mol"):
        raise ParallelError(f"mode must be total/mol, got '{mode}'")

    dev = system.device
    if mode == "total":
        with _named_group(system, group, "__dipcorr_tot") as g:
            pipe = TrajectoryAnalysis(
                system, device=dev, triclinic=_system_triclinic(system)
            ).add_total_dipole(g, name="M")
            out = pipe.runner(group=None, ship="all").run(trajectory, batch_size=batch_size)
        series = torch.as_tensor(np.asarray(out["M"], np.float32), device=dev)[:, None, :]
        times = np.asarray(out["times"], np.float64)
    else:
        idx = _transient_indices(system, group)
        if idx.size == 0:
            raise GroupError(f"group '{group}' is empty", code="EmptyGroup")
        topo = system.topology
        if not topo.has_charge[idx].all():
            raise GroupError(f"group '{group}' has atoms without charge",
                             code="InvalidCharge")
        name = "__dipcorr_sel"
        system.group_create_from_indices(name, idx)
        try:
            gsel, pos, boxes, dt = _resident_group_pos(system, trajectory, name, batch_size)
        finally:
            system.group_remove(name)
        _, blocks = _blocks_by_key(np.asarray(topo.molecule_ids())[idx])
        loc = np.searchsorted(gsel, idx)
        cols, w, qt, _ = _unit_tables(system, idx, blocks, loc, charges=True)
        series = _molecular_dipoles(
            pos, boxes, torch.as_tensor(cols, device=pos.device),
            torch.as_tensor(w, device=pos.device), torch.as_tensor(qt, device=pos.device))
        times = np.asarray(dt.times, np.float64)

    f = int(series.shape[0])
    lags = _check_lags(lags, f)
    corr = _fetch(msd_ops.lag_correlation(series, lags)).astype(np.float64)
    lag_times = times[lags] - times[0]
    phi = corr / corr[0] if corr[0] else corr
    # integral correlation time up to the first zero crossing of phi
    neg = np.flatnonzero(phi < 0)
    stop = int(neg[0]) if neg.size else len(phi)
    tau = _trapezoid(phi[:stop], lag_times[:stop]) if stop >= 2 else 0.0
    return {"lag_times": lag_times, "corr": corr, "phi": phi, "corr_time": tau}
