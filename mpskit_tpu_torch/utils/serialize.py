"""Checkpoint and resume of states (counterpart of
mpskit_tpu/utils/serialize.py), in the JAX package's `.npz` layout, so
that a checkpoint either package wrote loads in the other: `__type__`
names the container, `leaf_0`, `leaf_1`, ... hold its tensors in the JAX
package's pytree order, and the static data sits beside them (`__center__`,
`__nrows__`, `__momentum__`, `__trivial__`, `__bond_charges__`,
`__phys_charges__`, `__labels__`, `__anyon__`, `__cat__`).

Covered containers: FiniteMPS, InfiniteMPS, WindowMPS, MPSMultiline,
LeftGaugedQP, SymmetricFiniteMPS, SymmetricInfiniteMPS and
AnyonicInfiniteMPS, whose category is rebuilt by name from the built-in
ones (Fibonacci, Ising, Z_n, su2_k). Every iterative algorithm's
`finalize(iter, psi, H)` hook can call `save_state`.

A symmetric state's Z_n modulus goes into an extra `__modulus__` key: the
JAX package writes none and reloads every symmetric state as U(1), which
gives a Z_n state the wrong masks. A file without the key (a U(1) state,
or any JAX checkpoint) loads as U(1)."""

from __future__ import annotations

import numpy as np
import torch

from ..states.finitemps import FiniteMPS
from ..states.infinitemps import InfiniteMPS
from ..states.multiline import MPSMultiline
from ..states.quasiparticle import LeftGaugedQP
from ..states.windowmps import WindowMPS
from ..symmetry.anyonic import AnyonicInfiniteMPS
from ..symmetry.category import (
    fibonacci_category, ising_category, su2k_category, zn_category,
)
from ..symmetry.charges import SymmetricFiniteMPS, SymmetricInfiniteMPS


def _category_by_name(name: str):
    """A built-in category from its name, as the JAX package rebuilds it."""
    if name == "Fibonacci":
        return fibonacci_category()
    if name == "Ising":
        return ising_category()
    if name.startswith("Z") and name[1:].isdigit():
        return zn_category(int(name[1:]))
    if name.startswith("su2_"):
        return su2k_category(int(name[4:]))
    raise TypeError(f"cannot reconstruct category {name!r} by name; "
                    "checkpoint custom categories yourself")


def _leaves(psi) -> list:
    """The container's tensors in the JAX package's pytree order."""
    if isinstance(psi, FiniteMPS):
        return [psi.ALs, psi.ARs, psi.AC]
    if isinstance(psi, InfiniteMPS):
        return [psi.AL, psi.AR, psi.AC, psi.C]
    if isinstance(psi, WindowMPS):
        return (_leaves(psi.left_gs) + _leaves(psi.window)
                + _leaves(psi.right_gs))
    if isinstance(psi, MPSMultiline):
        return [t for row in psi.rows for t in _leaves(row)]
    if isinstance(psi, LeftGaugedQP):
        return ([psi.Xs, psi.VLs] + _leaves(psi.left_gs)
                + _leaves(psi.right_gs))
    if isinstance(psi, (SymmetricFiniteMPS, SymmetricInfiniteMPS,
                        AnyonicInfiniteMPS)):
        return _leaves(psi.state)
    raise TypeError(f"cannot checkpoint a {type(psi).__name__}")


def save_state(path: str, psi) -> None:
    """Save a state container to .npz with its static data."""
    tname = type(psi).__name__
    arrays = {"__type__": np.array(tname)}
    arrays.update({f"leaf_{i}": t.detach().cpu().resolve_conj().numpy()
                   for i, t in enumerate(_leaves(psi))})
    if isinstance(psi, FiniteMPS):
        arrays["__center__"] = np.array(psi.center)
    elif isinstance(psi, WindowMPS):
        arrays["__center__"] = np.array(psi.window.center)
    elif isinstance(psi, MPSMultiline):
        arrays["__nrows__"] = np.array(len(psi.rows))
    elif isinstance(psi, LeftGaugedQP):
        arrays["__momentum__"] = np.asarray(psi.momentum)
        arrays["__trivial__"] = np.array(bool(psi.trivial))
    elif isinstance(psi, (SymmetricFiniteMPS, SymmetricInfiniteMPS)):
        arrays["__bond_charges__"] = np.stack(
            [np.asarray(c) for c in psi.bond_charges])
        arrays["__phys_charges__"] = np.asarray(psi.phys_charges, int)
        if isinstance(psi, SymmetricFiniteMPS):
            arrays["__center__"] = np.array(psi.state.center)
        if psi.modulus is not None:
            arrays["__modulus__"] = np.array(int(psi.modulus))
    elif isinstance(psi, AnyonicInfiniteMPS):
        arrays["__labels__"] = np.asarray(psi.labels, int)
        arrays["__anyon__"] = np.array(psi.anyon)
        arrays["__cat__"] = np.array(psi.cat.name)
    np.savez(path, **arrays)


def load_state(path: str, device="cuda"):
    """Load a container that `save_state` (of either package) wrote, onto
    `device` (the card unless the caller asks for the CPU)."""
    data = np.load(path, allow_pickle=False)
    tname = str(data["__type__"])
    n = len([k for k in data.files if k.startswith("leaf_")])
    leaves = [torch.from_numpy(data[f"leaf_{i}"]).to(device)
              for i in range(n)]
    if tname == "FiniteMPS":
        return FiniteMPS(*leaves[:3], int(data["__center__"]))
    if tname == "InfiniteMPS":
        return InfiniteMPS(*leaves)
    if tname == "WindowMPS":
        return WindowMPS(InfiniteMPS(*leaves[0:4]),
                         FiniteMPS(*leaves[4:7], int(data["__center__"])),
                         InfiniteMPS(*leaves[7:11]))
    if tname == "MPSMultiline":
        return MPSMultiline(tuple(InfiniteMPS(*leaves[4 * r: 4 * r + 4])
                                  for r in range(int(data["__nrows__"]))))
    if tname == "LeftGaugedQP":
        return LeftGaugedQP(leaves[0], leaves[1], InfiniteMPS(*leaves[2:6]),
                            InfiniteMPS(*leaves[6:10]),
                            float(data["__momentum__"]),
                            bool(data["__trivial__"]))
    if tname in ("SymmetricFiniteMPS", "SymmetricInfiniteMPS"):
        sym = (tuple(np.asarray(row) for row in data["__bond_charges__"]),
               tuple(int(q) for q in data["__phys_charges__"]),
               int(data["__modulus__"]) if "__modulus__" in data.files
               else None)
        if tname == "SymmetricFiniteMPS":
            return SymmetricFiniteMPS(
                FiniteMPS(*leaves[:3], int(data["__center__"])), *sym)
        return SymmetricInfiniteMPS(InfiniteMPS(*leaves), *sym)
    if tname == "AnyonicInfiniteMPS":
        return AnyonicInfiniteMPS(
            InfiniteMPS(*leaves), _category_by_name(str(data["__cat__"])),
            int(data["__anyon__"]),
            tuple(tuple(int(x) for x in row) for row in data["__labels__"]))
    raise TypeError(f"unknown state type {tname}")
