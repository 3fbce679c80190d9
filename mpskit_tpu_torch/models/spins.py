"""Spin operator matrices (host-side numpy constructors)."""

from __future__ import annotations

import numpy as np


def pauli(dtype=np.complex128):
    """(X, Y, Z, I) Pauli matrices. Y is complex regardless of dtype; for a
    real dtype the other three are cast and Y stays complex128."""
    X = np.array([[0, 1], [1, 0]], dtype)
    Y = np.array([[0, -1j], [1j, 0]], np.result_type(dtype, np.complex64))
    Z = np.array([[1, 0], [0, -1]], dtype)
    I = np.eye(2, dtype=dtype)
    return X, Y, Z, I


def spinmatrices(s: float, dtype=np.complex128):
    """(Sx, Sy, Sz, I) spin-s matrices, d = 2s+1."""
    d = int(round(2 * s + 1))
    m = s - np.arange(d)  # s, s-1, ..., -s
    Sz = np.diag(m).astype(dtype)
    # S+ |s, m> = sqrt(s(s+1) - m(m+1)) |s, m+1>
    off = np.sqrt(s * (s + 1) - m[1:] * (m[1:] + 1))
    Sp = np.zeros((d, d), dtype)
    Sp[np.arange(d - 1), np.arange(1, d)] = off
    Sm = Sp.conj().T
    Sx = (Sp + Sm) / 2
    Sy = (Sp - Sm) / (2j)
    return Sx, Sy, Sz, np.eye(d, dtype=dtype)
