"""Expectation values (counterpart of mpskit_tpu/algorithms/expval.py:
the finite MPOHamiltonian branch and the infinite MPOHamiltonian,
one-site-operator and DenseMPO branches)."""

from __future__ import annotations

import numpy as np
import torch

from ..environments.finite import finite_environments, stack_W
from ..operators.mpo import DenseMPO, MPOHamiltonian
from ..states.finitemps import FiniteMPS
from ..states.infinitemps import InfiniteMPS
from .derivatives import ac_apply
from .expval_infinite import (
    expval_infinite_densempo, expval_infinite_local, expval_infinite_mpoham,
)


def _expval_finite_mpoham(psi: FiniteMPS, H: MPOHamiltonian, envs=None):
    if envs is None:
        envs = finite_environments(psi, H)
    c = psi.center
    W = stack_W(H, psi.length, psi.dtype, psi.device)[c]
    AC = psi.AC.reshape(-1)
    HAC = ac_apply(envs.leftenv(c), W, envs.rightenv(c), psi.AC).reshape(-1)
    return (torch.vdot(AC, HAC) / torch.vdot(AC, AC)).real


def expectation_value(psi, O, *args, envs=None):
    """expectation_value(psi, H) for an MPOHamiltonian: <psi|H|psi> /
    <psi|psi> of a FiniteMPS (0-dim tensor), the per-site energy density
    of an InfiniteMPS ((L,) tensor); expectation_value(psi, (site, O)) for
    a one-site operator on an InfiniteMPS; for a DenseMPO on an
    InfiniteMPS, the leading transfer eigenvalue per site (a host number,
    `expval_infinite_densempo`). Precomputed environments go by
    keyword, `envs=`, as in the JAX package. A positional argument after
    the operator (a site range or an int for a ranged energy, a time for a
    MultipliedOperator) and the other combinations come with later
    slices."""
    if args:
        raise NotImplementedError(
            f"expectation_value(psi, O, {args[0]!r}) is not ported yet: "
            "ranged energies and time-dependent operators come with queue-1 "
            "item 10 (ROADMAP.md); pass precomputed environments as envs=")
    if isinstance(psi, FiniteMPS) and isinstance(O, MPOHamiltonian):
        return _expval_finite_mpoham(psi, O, envs)
    if isinstance(psi, InfiniteMPS):
        if isinstance(O, MPOHamiltonian):
            return expval_infinite_mpoham(psi, O, envs)
        if isinstance(O, DenseMPO):
            return expval_infinite_densempo(psi, O, envs)
        if isinstance(O, tuple) and len(O) == 2:
            site, op = O
            if np.ndim(op) == 2 and np.shape(op)[0] == psi.physicaldim:
                return expval_infinite_local(psi, op, site)
    raise NotImplementedError(
        f"expectation_value({type(psi).__name__}, {type(O).__name__}) is not "
        "ported yet: finite local operators, operator strings, ranged "
        "energies and a finite DenseMPO come with queue-1 item 10 "
        "(ROADMAP.md)")
