"""Closed forms of the transverse-field Ising chain H = -sum Z_i Z_{i+1} -
g sum X_i (free fermions), for the configurations whose "exact" is
"tfim"."""

from __future__ import annotations

import numpy as np


def open_chain_e0(L: int, params: dict) -> float:
    """Ground energy of the open chain of L sites: minus the sum of the
    singular values of g*I + superdiag(1)."""
    A = params["g"] * np.eye(L) + np.diag(np.ones(L - 1), 1)
    return -float(np.linalg.svd(A, compute_uv=False).sum())

