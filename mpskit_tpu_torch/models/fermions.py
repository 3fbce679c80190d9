"""Fermionic chains (counterpart of mpskit_tpu/models/fermions.py).

The Jordan-Wigner transformation is applied once, when the operator is
built: every model here is nearest-neighbour after it, so the MPO tensors
carry the fermionic signs and every contraction stays a plain dense
product.

Conventions: site basis |0>, |1> (occupation) for spinless fermions;
|0>, |up>, |down>, |updown> for spinful ones. JW: c_i = (prod_{j<i} Z_j)
s^-_i with Z = diag(1, -1) in the occupation basis, s^- |1> = |0>. So
<c_i^dag c_j> (i < j) is the string correlator of (c^dag Z)_i, Z on the
sites between, and c_j.
"""

from __future__ import annotations

import numpy as np

from ..operators.mpo import MPOHamiltonian
from .hamiltonians import _two_site


def _spinless_ops(dtype=np.float64):
    """(c, c^dag, n, Z) in the occupation basis (n = c^dag c, Z = 1 - 2n)."""
    c = np.zeros((2, 2), dtype)
    c[0, 1] = 1.0                      # annihilate: |1> -> |0>
    cdag = c.T.copy()
    n = cdag @ c
    Z = np.eye(2, dtype=dtype) - 2 * n
    return c, cdag, n, Z


def kitaev_chain(t: float = 1.0, mu: float = 0.0, delta: float = 0.0,
                 period: int = 1, dtype=np.float64) -> MPOHamiltonian:
    """H = sum_i [-t (c_i^dag c_{i+1} + h.c.) + delta (c_i c_{i+1} + h.c.)
    - mu n_i], the chemical potential on every site of a finite chain.
    With c_i = Z_{<i} s^-_i, c_i^dag c_{i+1} = (s^+ Z)_i s^-_{i+1}."""
    c, cdag, n, Z = _spinless_ops(dtype)
    hop = _two_site(cdag @ Z, c) + _two_site(Z @ c, cdag)
    pair = _two_site(cdag @ Z, cdag) + _two_site(Z @ c, c)
    Hbond = MPOHamiltonian.from_local(-t * hop + delta * pair, period=period,
                                      dtype=dtype)
    Hmu = MPOHamiltonian.from_local(-mu * n, period=period, dtype=dtype)
    return Hbond + Hmu


def free_fermions(t: float = 1.0, mu: float = 0.0, period: int = 1,
                  dtype=np.float64) -> MPOHamiltonian:
    """Tight-binding chain H = -t sum (c^dag c + h.c.) - mu sum n."""
    return kitaev_chain(t=t, mu=mu, delta=0.0, period=period, dtype=dtype)


def kitaev_bdg_energy(L: int, t: float, mu: float, delta: float) -> float:
    """Exact open-chain ground energy of `kitaev_chain` by
    Bogoliubov-de-Gennes diagonalization (at delta=0 the sum of the
    negative eigenvalues of the hopping matrix)."""
    A = np.zeros((L, L))
    B = np.zeros((L, L))
    for i in range(L):
        A[i, i] = -mu
    for i in range(L - 1):
        A[i, i + 1] = A[i + 1, i] = -t
        B[i, i + 1] = delta
        B[i + 1, i] = -delta
    ev = np.linalg.eigvalsh(np.block([[A, B], [-B, -A]]))
    # H = (1/2) sum_k E_k (2 gamma^dag gamma - 1) + (1/2) tr A
    return -0.5 * np.sum(ev[ev > 0]) + 0.5 * np.trace(A)


def _spinful_ops(dtype=np.float64):
    """(c_up, c_dn, n_up, n_dn, P) on the 4-dim site (|0>, |up>, |dn>,
    |updn>), up ordered before down inside the site: c_up = s^-_up,
    c_dn = Z_up s^-_dn; P the site parity."""
    c1, _, n1, Z1 = _spinless_ops(dtype)
    I2 = np.eye(2, dtype=dtype)
    return (np.kron(c1, I2), np.kron(Z1, c1), np.kron(n1, I2),
            np.kron(I2, n1), np.kron(Z1, Z1))


def hubbard(t: float = 1.0, U: float = 0.0, mu: float = 0.0,
            period: int = 1, dtype=np.float64) -> MPOHamiltonian:
    """H = -t sum_{i,s} (c_{i,s}^dag c_{i+1,s} + h.c.) + U sum_i n_up n_dn
    - mu sum_i (n_up + n_dn), JW over (1up, 1dn, 2up, 2dn, ...): a hop
    from site i crosses both modes of the site, (c_s^dag P)_i (c_s)_{i+1}."""
    c_up, c_dn, n_up, n_dn, P = _spinful_ops(dtype)
    hop = (_two_site(c_up.T @ P, c_up) + _two_site(P @ c_up, c_up.T) +
           _two_site(c_dn.T @ P, c_dn) + _two_site(P @ c_dn, c_dn.T))
    Hbond = MPOHamiltonian.from_local(-t * hop, period=period, dtype=dtype)
    Hloc = MPOHamiltonian.from_local(
        U * (n_up @ n_dn) - mu * (n_up + n_dn), period=period, dtype=dtype)
    return Hbond + Hloc
