"""Krylov matrix-exponential application (counterpart of
mpskit_tpu/linalg/expm.py).

`expm_multiply`: y = exp(tau * A) v for Hermitian A, from one Lanczos
factorization; `tau` may be complex (-i dt for TDVP).
`expm_multiply_arnoldi`: general A, from one Arnoldi factorization.

The JAX package solves the small m x m problem on the device. Here the
factorization already reads its alpha/beta (its Hessenberg matrix) on the
host, once, so the small problem is solved there in float64 / complex128:
the `eigh` of the tridiagonal, exp(tau * evals) and Saad's error estimate,
or a Pade `expm` of the Hessenberg matrix. Only the m coefficients of the
result travel back to the device. An exponential thus costs one host sync,
and its error estimate (a host float) none. A `graphs.Bound` matvec on
the card runs the factorization as one CUDA graph replay
(`linalg/lanczos.py`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .arnoldi import arnoldi_factorize
from .basis import basis_combine
from .lanczos import _tridiag, lanczos_factorize
from ..utils.trace import span
from ..utils.tree import norm


def _combine(V, coeff):
    """sum_k coeff[k] V[k] from host coefficients, in V's dtype made complex
    where the coefficients are (a real basis with a complex tau)."""
    dtype = V.dtype
    if np.iscomplexobj(coeff) and not dtype.is_complex:
        dtype = torch.complex64 if dtype == torch.float32 else \
            torch.complex128
    return basis_combine(V.to(dtype), torch.as_tensor(coeff, device=V.device))


def expm_multiply_err(matvec: Callable, v, tau, m: int = 30):
    """exp(tau*A) v with A Hermitian, and a relative Krylov truncation-error
    estimate |beta_last * coeff_last| (a host float): drivers keep the worst
    estimate of a step and warn when the Krylov dimension was too small."""
    with span("expm"):
        n0 = norm(v)
        V, alpha, beta, nvalid = lanczos_factorize(matvec, v, m)
        # sentinel 0 on the decoupled invalid block: e1 has no weight there
        evals, evecs = np.linalg.eigh(_tridiag(alpha, beta, nvalid, 0.0))
        coeff = evecs @ (np.exp(tau * evals) * evecs[0].conj())
        y = _combine(V[:m], coeff)
        last = min(max(nvalid - 1, 0), m - 1)
        err = float(abs(beta[last]) * abs(coeff[last]))
        return n0 * y, err


def expm_multiply(matvec: Callable, v, tau, m: int = 30):
    """exp(tau*A) v with A Hermitian. For |tau|*||A|| beyond ~10 increase m
    or split the step."""
    return expm_multiply_err(matvec, v, tau, m)[0]


def _pade_expm(A):
    """exp(A) of a small host matrix: Pade(13) with scaling and squaring
    (Higham 2005), the degree the JAX package's `expm` takes for matrices
    of non-trivial norm."""
    b = (64764752532480000., 32382376266240000., 7771770303897600.,
         1187353796428800., 129060195264000., 10559470521600.,
         670442572800., 33522128640., 1323241920., 40840800., 960960.,
         16380., 182., 1.)
    nrm = np.linalg.norm(A, 1)
    s = max(0, int(np.ceil(np.log2(nrm / 5.371920351148152)))) if nrm else 0
    A = A / 2.0 ** s
    eye = np.eye(A.shape[0], dtype=A.dtype)
    A2 = A @ A
    A4 = A2 @ A2
    A6 = A4 @ A2
    U = A @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2)
             + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye)
    V = (A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2)
         + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye)
    E = np.linalg.solve(V - U, V + U)
    for _ in range(s):
        E = E @ E
    return E


def expm_multiply_arnoldi(matvec: Callable, v, tau, m: int = 30):
    """exp(tau*A) v for general A."""
    n0 = norm(v)
    V, H, nvalid = arnoldi_factorize(matvec, v, m)
    mask = np.arange(m) < nvalid
    Hm = np.where(mask[:, None] & mask[None, :], H[:m, :m], 0.0)
    E = _pade_expm(tau * Hm)
    return n0 * _combine(V[:m], E[:, 0])
