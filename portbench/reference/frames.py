"""What the oracles read for one block of frames (`Frames`), and the
helpers that several oracles share.

`Frames` holds positions from the generator's grid, boxes, masses,
charges and the configuration's groups, in one dtype (float64 for the
reference, float32 on TF32-rounded inputs for the control).
"""

from __future__ import annotations

import torch

from . import plain as P


class Frames:
    """One block of frames and the system tables, as the oracles read them."""

    def __init__(self, syn, p, dtype, round_inputs=None, analysis=()):
        dev = p.device
        self.analysis, self._pairs = analysis, {}
        rnd = round_inputs or (lambda t: t.to(dtype))
        self.syn = syn
        self.p = rnd(p)
        f = p.shape[0]
        box = torch.as_tensor(syn.h, device=dev).to(torch.float64)
        box = box if syn.triclinic else torch.diagonal(box)
        self.box = rnd(box.expand(f, *box.shape).contiguous())
        self.mass = rnd(torch.as_tensor(syn.masses(), device=dev))
        self.charge = rnd(torch.as_tensor(syn.charges(), device=dev))
        self.rnd = rnd
        self.groups = {k: slice(*v) for k, v in syn.config["groups"].items()}

    def group(self, name):
        return self.p[:, self.groups[name]]

    def pairs(self, g1: str, g2: str, tol: float):
        """(minimum distance, {cutoff: (lo, hi)}) of groups g1 x g2 over
        the cutoffs of every `add_contacts` of the analysis: one sweep."""
        key = (g1, g2, tol)
        if key not in self._pairs:
            cuts = [float(c["args"][2] if len(c.get("args", [])) > 2 else c["kwargs"]["cutoff"])
                    for c in self.analysis if c["call"] == "add_contacts"
                    and c["args"][:2] == [g1, g2]]
            self._pairs[key] = P.pair_sweep(self.group(g1), self.group(g2), self.box,
                                            cuts, tol)
        return self._pairs[key]

    def weights(self, name):
        return self.mass[self.groups[name]]

    def ref_frame(self):
        q0 = self.syn.grid_frame0()
        return self.rnd(self.syn.positions(q0).to(self.p.device))

    def ref_box(self):
        return self.box[0]


AXES = {"x": 0, "y": 1, "z": 2}


def center(fr: Frames, group: str, com: bool):
    """The refined centre of `group`, mass-weighted when `com`."""
    return P.refined_center(fr.group(group), fr.box, fr.weights(group) if com else None)


def sites(fr: Frames, name: str):
    """The generator's index table `name` on the frames' device."""
    return torch.as_tensor(fr.syn.layout()[name], device=fr.p.device)


def ulp_nm(fr: Frames) -> float:
    """One float32 ulp at the box's longest edge, nm: what rounding a
    coordinate moves an atom by."""
    return float(P.box_lengths(fr.box.to(torch.float64)).max()) * 2.0 ** -23
