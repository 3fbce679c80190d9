"""Model Hamiltonians (counterpart of mpskit_tpu/models/hamiltonians.py,
same conventions and FSM layouts). Each builds a host-numpy
MPOHamiltonian; `environments.finite.stack_W` moves it to a device on
use."""

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


def transverse_field_ising_parity(g: float = 1.0, period: int = 1,
                                  dtype=np.float64) -> MPOHamiltonian:
    """H = -sum_bonds X X - g sum_sites Z: the TFIM in the basis where its
    Z2 spin-flip parity is diagonal (unitarily equivalent to
    `transverse_field_ising_lattice`, X <-> Z)."""
    X, _, Z, I = pauli(dtype)
    Hxx = MPOHamiltonian.from_local(-_two_site(X, X), period=period,
                                    dtype=dtype)
    Hz = MPOHamiltonian.from_local(-g * Z, period=period, dtype=dtype)
    return Hxx + Hz


def xx_chain_with_field(h: float = 0.0, period: int = 1,
                        dtype=np.float64) -> MPOHamiltonian:
    """H = -sum_bonds (XX + YY)/2 + h sum_i n_i with n = (1 - Z)/2: free
    fermions under Jordan-Wigner (open-chain modes h - 2 cos(k pi /
    (L+1)))."""
    X, Y, Z, I = pauli(dtype)
    hop = (_two_site(X, X) + np.real(_two_site(Y, Y))) / 2
    n = (I - Z) / 2
    Hhop = MPOHamiltonian.from_local(-hop, period=period, dtype=dtype)
    Hn = MPOHamiltonian.from_local(h * n, period=period, dtype=dtype)
    return Hhop + Hn


def heisenberg_XXX(spin: float = 1, period: int = 1,
                   dtype=np.complex128) -> MPOHamiltonian:
    """H = 4 * sum_bonds S_i . S_{i+1}."""
    Sx, Sy, Sz, _ = spinmatrices(spin)
    H2 = _two_site(Sx, Sx) + _two_site(Sy, Sy) + _two_site(Sz, Sz)
    # S.S is real in the Sz basis (the two imaginary factors cancel)
    return MPOHamiltonian.from_local(4 * H2, period=period, dtype=dtype)


def heisenberg_XXZ(spin: float = 1, delta: float = 1.0, period: int = 1,
                   dtype=np.complex128) -> MPOHamiltonian:
    """H = 4 * sum_bonds [Sx Sx + Sy Sy + delta Sz Sz]."""
    Sx, Sy, Sz, _ = spinmatrices(spin, dtype)
    H2 = _two_site(Sx, Sx) + _two_site(Sy, Sy) + delta * _two_site(Sz, Sz)
    return MPOHamiltonian.from_local(4 * H2, period=period, dtype=dtype)


def bilinear_biquadratic_model(theta: float = np.arctan(1 / 3),
                               period: int = 1,
                               dtype=np.complex128) -> MPOHamiltonian:
    """H = sum_bonds [cos(theta) (S.S) + sin(theta) (S.S)^2], spin 1."""
    Sx, Sy, Sz, _ = spinmatrices(1)
    h1 = np.kron(Sx, Sx) + np.kron(Sy, Sy) + np.kron(Sz, Sz)
    H = np.cos(theta) * h1 + np.sin(theta) * (h1 @ h1)
    return MPOHamiltonian.from_local(H.reshape(3, 3, 3, 3), period=period,
                                     dtype=dtype)


def heisenberg_XYZ(Jx: float = 1.0, Jy: float = 1.0, Jz: float = 1.0,
                   spin: float = 0.5, period: int = 1,
                   dtype=np.complex128) -> MPOHamiltonian:
    """H = sum_bonds [Jx Sx Sx + Jy Sy Sy + Jz Sz Sz] (Sy x Sy is real in
    the Sz basis, so real dtypes work)."""
    Sx, Sy, Sz, _ = spinmatrices(spin)
    H2 = (Jx * _two_site(Sx, Sx) + Jy * np.real(_two_site(Sy, Sy))
          + Jz * _two_site(Sz, Sz))
    return MPOHamiltonian.from_local(H2, period=period, dtype=dtype)


def xy_model(gamma: float = 1.0, g: float = 1.0, period: int = 1,
             dtype=np.complex128) -> MPOHamiltonian:
    """H = -sum_i [(1+gamma)/2 X X + (1-gamma)/2 Y Y] - g sum_i Z; gamma=1
    is the TFIM lattice model, gamma=0 the isotropic XX chain."""
    X, Y, Z, _ = pauli(dtype)
    H2 = (-(1 + gamma) / 2 * _two_site(X, X)
          - (1 - gamma) / 2 * np.real(_two_site(Y, Y)))
    Hb = MPOHamiltonian.from_local(H2, period=period, dtype=dtype)
    Hf = MPOHamiltonian.from_local(-g * Z, period=period, dtype=dtype)
    return Hb + Hf


def _clock_ops(q: int):
    """Z = diag(omega^a), X = cyclic shift (X|a> = |a+1 mod q>)."""
    Z = np.diag(np.exp(2j * np.pi / q) ** np.arange(q))
    X = np.roll(np.eye(q), 1, axis=0)
    return X, Z


def quantum_potts(q: int = 3, g: float = 1.0, period: int = 1,
                  dtype=np.complex128) -> MPOHamiltonian:
    """H = -sum_i sum_{k=1}^{q-1} Z_i^k (Z_{i+1}^dag)^k - g sum_i
    sum_{k=1}^{q-1} X_i^k; self-dual at g=1, the TFIM lattice model at
    q=2."""
    X, Z = _clock_ops(q)
    H2 = np.zeros((q * q, q * q), complex)
    H1 = np.zeros((q, q), complex)
    for k in range(1, q):
        Zk = np.linalg.matrix_power(Z, k)
        H2 -= np.kron(Zk, Zk.conj().T)
        H1 -= g * np.linalg.matrix_power(X, k)
    assert np.allclose(H2, H2.conj().T) and np.allclose(H1, H1.conj().T)
    Hb = MPOHamiltonian.from_local(
        np.real(H2).reshape(q, q, q, q), period=period, dtype=dtype)
    Hf = MPOHamiltonian.from_local(np.real(H1), period=period, dtype=dtype)
    return Hb + Hf


def quantum_clock(q: int = 3, g: float = 1.0, period: int = 1,
                  dtype=np.complex128) -> MPOHamiltonian:
    """H = -sum_i (Z_i Z_{i+1}^dag + h.c.) - g sum_i (X_i + X_i^dag)."""
    X, Z = _clock_ops(q)
    H2 = -(np.kron(Z, Z.conj().T) + np.kron(Z.conj().T, Z))
    H1 = -g * (X + X.conj().T)
    Hb = MPOHamiltonian.from_local(
        np.real(H2).reshape(q, q, q, q), period=period, dtype=dtype)
    Hf = MPOHamiltonian.from_local(np.real(H1), period=period, dtype=dtype)
    return Hb + Hf


def bose_hubbard(t: float = 1.0, U: float = 1.0, mu: float = 0.0,
                 n_max: int = 3, period: int = 1,
                 dtype=np.complex128) -> MPOHamiltonian:
    """H = -t sum_i (b_i^dag b_{i+1} + h.c.) + U/2 sum_i n_i (n_i - 1)
    - mu sum_i n_i, occupations truncated at n_max (d = n_max + 1)."""
    d = n_max + 1
    n = np.arange(d, dtype=float)
    b = np.zeros((d, d))
    b[np.arange(d - 1), np.arange(1, d)] = np.sqrt(n[1:])  # b|n> = sqrt(n)|n-1>
    N = np.diag(n)
    H2 = -t * (_two_site(b.T, b) + _two_site(b, b.T))
    H1 = U / 2 * N @ (N - np.eye(d)) - mu * N
    Hb = MPOHamiltonian.from_local(H2, period=period, dtype=dtype)
    Hf = MPOHamiltonian.from_local(H1, period=period, dtype=dtype)
    return Hb + Hf
