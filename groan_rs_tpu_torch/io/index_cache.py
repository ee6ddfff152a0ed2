"""Resumable trajectory-pass state.

Port of `PassState` (`groan_rs_tpu/io/index_cache.py:75-134`): the frame
cursor of a pass plus its partial reduction (a tree of arrays, see
`utils/tree.py`), saved with numpy in the JAX package's layout (magic,
cursor, `leaf_i`).  The JAX module's frame-index cache is not ported: a
scan of the port's files costs milliseconds.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.tree import tree_flatten, tree_unflatten

__all__ = ["PassState"]

_MAGIC = "groan-gxidx-v2"


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


class PassState:
    """Frames processed so far and the partial reduction.

        state = PassState.load(path, like=init) or PassState(0, init)
        ... run batches from state.cursor, fold into carry ...
        state.update(cursor, carry); state.save(path)
    """

    def __init__(self, cursor: int = 0, carry=None):
        self.cursor = int(cursor)
        self.carry = carry

    def update(self, cursor: int, carry) -> "PassState":
        self.cursor = int(cursor)
        self.carry = carry
        return self

    def save(self, path) -> None:
        leaves, _ = tree_flatten(self.carry)
        np.savez(str(path), __magic__=_MAGIC, __cursor__=self.cursor,
                 **{f"leaf_{i}": _host(v) for i, v in enumerate(leaves)})

    @classmethod
    def load(cls, path, like=None) -> "PassState | None":
        """Load a checkpoint (None when there is none or it is not one);
        `like` is an example carry whose structure the leaves take (its
        values are ignored)."""
        p = str(path)
        if not os.path.exists(p) and os.path.exists(p + ".npz"):
            p = p + ".npz"
        if not os.path.exists(p):
            return None
        try:
            with np.load(p, allow_pickle=False) as z:
                if str(z["__magic__"]) != _MAGIC:
                    return None
                cursor = int(z["__cursor__"])
                n = sum(1 for k in z.files if k.startswith("leaf_"))
                leaves = [z[f"leaf_{i}"] for i in range(n)]
        except (OSError, ValueError, KeyError):
            return None
        if like is not None:
            carry = tree_unflatten(tree_flatten(like)[1], leaves)
        elif len(leaves) == 1:
            carry = leaves[0]
        else:
            carry = leaves
        return cls(cursor, carry)
