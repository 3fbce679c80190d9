"""Finite-temperature purifications (counterpart of
mpskit_tpu/algorithms/thermal.py).

rho(beta) = e^{-beta H} is represented by its purification

    |rho(beta/2)> = (e^{-(beta/2) H} (x) 1) |vec 1>,

an MPS with a doubled (d^2) physical leg, ket-major (index s*d + sigma).
Thermal averages are plain MPS expectation values of the ket-lifted
operator, <O>_beta = <psi| (O (x) 1) |psi> / <psi|psi>. Imaginary-time
evolution is `make_time_mpo` at dt = -i dbeta (exp(-i H dt) = exp(-dbeta
H)) lifted to the ket leg and applied by `apply_densempo_finite`."""

from __future__ import annotations

import numpy as np
import torch

from ..operators.apply import apply_densempo_finite
from ..operators.mpo import DenseMPO, MPOHamiltonian
from ..states.finitemps import FiniteMPS
from .expval import expectation_value
from .timeevmpo import WII, make_time_mpo


def purification_mps(d: int, L: int, D: int, dtype=torch.complex128,
                     device="cuda") -> FiniteMPS:
    """|vec 1>^{(x)L}, the infinite-temperature purified state: every site
    carries the maximally entangled ket-bra pair (physical dimension d^2),
    on `device` (the card unless the caller asks for the CPU)."""
    A = torch.zeros((L, D, d * d, D), dtype=dtype, device=device)
    A[:, 0, :, 0] = torch.from_numpy(np.eye(d).reshape(-1) / np.sqrt(d)).to(
        dtype)
    return FiniteMPS.from_tensors(A)


def lift_hamiltonian(H: MPOHamiltonian) -> MPOHamiltonian:
    """H (x) 1: H acts on the ket leg of the purification, the bra leg rides
    along on an identity."""
    L, w, _, d, _ = H.W.shape
    Wl = np.einsum("iabst,uv->iabsutv", H.W, np.eye(d)).reshape(
        L, w, w, d * d, d * d)
    return MPOHamiltonian.from_dense_W(Wl)


def lift_densempo(U: DenseMPO) -> DenseMPO:
    """U (x) 1 on the doubled physical leg, site by site (host arrays)."""
    out = []
    for i in range(U.period):
        O = np.asarray(U.site(i))
        wl, wr, d, _ = O.shape
        out.append(np.einsum("abst,uv->absutv", O, np.eye(d)).reshape(
            wl, wr, d * d, d * d))
    return DenseMPO(tuple(out))


def thermal_state(H: MPOHamiltonian, L: int, beta: float, dbeta: float,
                  Dmax: int, alg=None, device="cuda") -> FiniteMPS:
    """The purification of rho(beta) = e^{-beta H}: |vec 1> evolved through
    beta/2 of imaginary time in steps of dbeta (the evolution MPO's error is
    O(dbeta^2) per step for WII / TaylorCluster(2)), normalized after each
    step. Returns a complex128 FiniteMPS with bond dimension Dmax on
    `device` (the card unless the caller asks for the CPU)."""
    if alg is None:
        alg = WII()
    nsteps = int(round((beta / 2) / dbeta))
    if abs(nsteps * dbeta - beta / 2) >= 1e-12:
        raise ValueError("beta/2 must be an integer number of dbeta steps")
    U = lift_densempo(make_time_mpo(H, -1j * dbeta, alg))
    psi = purification_mps(H.physicaldim, L, Dmax, torch.complex128, device)
    for _ in range(nsteps):
        psi = apply_densempo_finite(U, psi, Dmax=Dmax).normalize()
    return psi


def thermal_expectation(psi: FiniteMPS, H: MPOHamiltonian):
    """<H>_beta (the total, not per site) from the purification psi =
    |rho(beta/2)>, a 0-dim real tensor."""
    e = expectation_value(psi, lift_hamiltonian(H))
    return e.real / psi.dot(psi).real
