"""Infinite-state expectation values (counterpart of the MPOHamiltonian,
local-operator and DenseMPO parts of
mpskit_tpu/algorithms/expval_infinite.py)."""

from __future__ import annotations

import torch

from ..environments.finite import stack_W
from ..environments.infinite_ham import hamiltonian_environments, pairing
from ..environments.infinite_mpo import mpo_environments
from ..operators.mpo import MPOHamiltonian
from ..states.infinitemps import InfiniteMPS


def expval_infinite_mpoham(psi: InfiniteMPS, H: MPOHamiltonian, envs=None):
    """Per-site energy density, an (L,) real tensor: at site i, the
    contributions that close into the final FSM level, paired with the
    right cap."""
    if envs is None:
        envs = hamiltonian_environments(psi, H)
    L, w = psi.period, H.odim
    Ws = stack_W(H, L, psi.dtype, psi.device)
    ens = []
    for i in range(L):
        A = psi.AL[i]
        t = torch.einsum("axy,ytn->axtn", envs.GLs[i], A)
        t = torch.einsum("axtn,ast->xsn", t, Ws[i, :, w - 1])
        closed = torch.einsum("xsm,xsn->mn", A.conj(), t)
        ens.append(pairing(closed, psi.rho_right(i)).real)
    return torch.stack(ens)


def expval_infinite_local(psi: InfiniteMPS, O, site: int):
    """<O> of a one-site operator O (d, d) at `site` (a 0-dim tensor)."""
    AC = psi.AC[site % psi.period]
    O = torch.as_tensor(O, device=AC.device).to(AC.dtype)
    num = torch.einsum("lsr,st,ltr->", AC.conj(), O, AC)
    return num / torch.vdot(AC.reshape(-1), AC.reshape(-1))


def expval_infinite_densempo(psi: InfiniteMPS, O, envs=None):
    """Leading-eigenvalue density of a transfer MPO: lambda_cell^(1/L) of
    the dominant <psi|O|psi> channel fixed point, a host number (complex
    for a complex state; the principal root)."""
    if envs is None:
        envs = mpo_environments(psi, O)
    return envs.lambda_cell ** (1.0 / psi.period)
