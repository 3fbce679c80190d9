"""Expectation values (counterpart of mpskit_tpu/algorithms/expval.py,
the finite MPOHamiltonian branch)."""

from __future__ import annotations

import torch

from ..environments.finite import finite_environments, stack_W
from ..operators.mpo import MPOHamiltonian
from ..states.finitemps import FiniteMPS
from .derivatives import ac_apply


def _expval_finite_mpoham(psi: FiniteMPS, H: MPOHamiltonian, envs=None):
    if envs is None:
        envs = finite_environments(psi, H)
    c = psi.center
    W = stack_W(H, psi.length, psi.dtype, psi.device)[c]
    AC = psi.AC.reshape(-1)
    HAC = ac_apply(envs.leftenv(c), W, envs.rightenv(c), psi.AC).reshape(-1)
    return (torch.vdot(AC, HAC) / torch.vdot(AC, AC)).real


def expectation_value(psi, O, envs=None):
    """<psi|H|psi> / <psi|psi> for a FiniteMPS and an MPOHamiltonian (a
    0-dim tensor). Other states and operators come with later slices."""
    if isinstance(psi, FiniteMPS) and isinstance(O, MPOHamiltonian):
        return _expval_finite_mpoham(psi, O, envs)
    raise NotImplementedError(
        f"expectation_value({type(psi).__name__}, {type(O).__name__}) is not "
        "ported yet: local operators and DenseMPO come with queue-1 slice 10, "
        "infinite states with slice 4 (ROADMAP.md)")
