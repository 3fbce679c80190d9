"""Model Hamiltonians on this slice's path (counterpart of
mpskit_tpu/models/hamiltonians.py, same conventions and FSM layouts)."""

from __future__ import annotations

import numpy as np

from ..operators.mpo import MPOHamiltonian
from .spins import pauli, spinmatrices


def _two_site(A, B):
    """A (x) B as a (d, d, d, d) array ordered [s1, s2, t1, t2]."""
    d = A.shape[0]
    return np.einsum("st,uv->sutv", A, B).reshape(d, d, d, d)


def transverse_field_ising(g: float = 1.0, period: int = 1,
                           dtype=np.complex128) -> MPOHamiltonian:
    """H = -sum_bonds [Z Z + g/2 (X 1 + 1 X)]."""
    X, _, Z, I = pauli(dtype)
    H2 = _two_site(Z, Z) + (g / 2) * (_two_site(X, I) + _two_site(I, X))
    return MPOHamiltonian.from_local(-H2, period=period, dtype=dtype)


def transverse_field_ising_lattice(g: float = 1.0, period: int = 1,
                                   dtype=np.complex128) -> MPOHamiltonian:
    """H = -sum_bonds Z Z - g sum_sites X (full field on the edge sites of
    finite chains); the w=3 FSM of the DMRG benchmark."""
    X, _, Z, I = pauli(dtype)
    Hzz = MPOHamiltonian.from_local(-_two_site(Z, Z), period=period,
                                    dtype=dtype)
    Hx = MPOHamiltonian.from_local(-g * X, period=period, dtype=dtype)
    return Hzz + Hx


def heisenberg_XXX(spin: float = 1, period: int = 1,
                   dtype=np.complex128) -> MPOHamiltonian:
    """H = 4 * sum_bonds S_i . S_{i+1}."""
    Sx, Sy, Sz, _ = spinmatrices(spin)
    H2 = _two_site(Sx, Sx) + _two_site(Sy, Sy) + _two_site(Sz, Sz)
    # S.S is real in the Sz basis (the two imaginary factors cancel)
    return MPOHamiltonian.from_local(4 * H2, period=period, dtype=dtype)
