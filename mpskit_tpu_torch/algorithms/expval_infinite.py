"""Infinite-state expectation values (counterpart of
mpskit_tpu/algorithms/expval_infinite.py): the energy density of an
MPOHamiltonian, the energy of a window of sites, one-site operators and
the DenseMPO eigenvalue density."""

from __future__ import annotations

import torch

from ..environments.finite import stack_W
from ..environments.infinite_ham import hamiltonian_environments, pairing
from ..environments.infinite_mpo import mpo_environments
from ..operators.mpo import MPOHamiltonian
from ..states.infinitemps import InfiniteMPS
from ..transfermatrix.transfer import transfer_left_mpo


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


def expval_infinite_ranged(psi: InfiniteMPS, H: MPOHamiltonian, rng,
                           envs=None):
    """The energy of H restricted to the window of sites `rng` (an int n
    means range(0, n)): f + n e, with e the density and f a boundary
    constant. The left environment at the window's start is closed with C
    on both layers, carried through the window in the AR gauge and paired
    with the right environment at its last site (a 0-dim tensor)."""
    if isinstance(rng, int):
        rng = range(0, rng)
    if envs is None:
        envs = hamiltonian_environments(psi, H)
    L = psi.period
    start, stop = rng.start, rng.stop - 1
    Ws = stack_W(H, L, psi.dtype, psi.device)
    C0 = psi.C[(start - 1) % L]
    x = torch.einsum("axy,xm,yn->amn", envs.GLs[start % L], C0.conj(), C0)
    for i in range(start, stop + 1):
        A = psi.AR[i % L]
        x = transfer_left_mpo(x, Ws[i % L], A, A)
    return torch.einsum("axy,axy->", x, envs.GRs[stop % L])
