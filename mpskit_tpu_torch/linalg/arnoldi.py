"""Arnoldi for the dominant (largest-magnitude) and the smallest-real-part
eigenpair of a general operator (counterpart of
mpskit_tpu/linalg/arnoldi.py): the transfer-matrix fixed points of the
uniform gauge fix, and the non-Hermitian quasiparticle solve.

`arnoldi_factorize` runs a fixed number of steps with no data-dependent
exit, so its Hessenberg matrix stays on the device and is read once, at the
end. The small Hessenberg eigenproblem is the JAX package's 300-step power
iteration, run on the host in float64 (complex128 for a complex operator)
numpy; only the m Ritz coefficients travel back to the device. The
smallest-real-part selection is LAPACK's `eig` on the host, where the JAX
package reaches it through a host callback. The other host-callback
variants of the JAX module (full small spectra, real selection) come with
later slices.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils.sync import to_host_array
from ..utils.tree import add, norm
from .basis import basis_combine, basis_inner_all, basis_zeros

_BREAKDOWN = 1e-14


def arnoldi_factorize(matvec: Callable, v0, m: int, passes: int = 2):
    """m Arnoldi steps with `passes` Gram-Schmidt passes against the
    stacked basis (2, CGS2, by default). Returns (V, H, nvalid): V the
    device basis of m + 1 slots, H the (m + 1, m) Hessenberg matrix as a
    float64 / complex128 numpy array, nvalid the steps before breakdown."""
    v = v0 / torch.clamp(norm(v0), min=_BREAKDOWN)
    V = basis_zeros(v, m + 1)
    V[0] = v
    cols = []
    for j in range(m):
        w = matvec(V[j])
        c1 = basis_inner_all(V, w)
        w = add(w, basis_combine(V, c1), alpha=-1.0)
        if passes > 1:
            c2 = basis_inner_all(V, w)
            w = add(w, basis_combine(V, c2), alpha=-1.0)
            c1 = c1 + c2
        b = norm(w)
        V[j + 1] = w * torch.where(b > _BREAKDOWN,
                                   1.0 / torch.clamp(b, min=_BREAKDOWN),
                                   torch.zeros_like(b))
        cols.append(c1)
        cols.append(b.reshape(1))
    flat = to_host_array(*cols).reshape(m, m + 2)
    H = flat[:, : m + 1].T.astype(
        np.complex128 if np.iscomplexobj(flat) else np.float64)
    H[np.arange(1, m + 1), np.arange(m)] = flat[:, m + 1]
    broke = np.abs(np.diagonal(H, offset=-1)) <= _BREAKDOWN
    nvalid = int(np.argmax(broke)) + 1 if broke.any() else m
    return V, H, nvalid


def small_eig_dominant(Hm, nvalid: int, iters: int = 300):
    """Dominant eigenpair of a small (m, m) host matrix by power iteration
    with a Rayleigh-quotient eigenvalue, on its leading nvalid block, from
    the JAX package's deterministic generic start vector."""
    m = Hm.shape[0]
    mask = np.arange(m) < nvalid
    Hm = np.where(mask[:, None] & mask[None, :], Hm, 0.0)
    z = np.where(mask, 1.0 + 0.1 * np.arange(m), 0.0).astype(Hm.dtype)
    z = z / np.linalg.norm(z)
    for _ in range(iters):
        z = Hm @ z
        z = z / max(np.linalg.norm(z), _BREAKDOWN)
    return np.vdot(z, Hm @ z), z


class EigsResult(NamedTuple):
    eigenvalue: complex
    eigenvector: torch.Tensor
    residual: float
    iterations: int
    converged: bool


def dominant_eigs(matvec: Callable, v0, m: int = 30, maxrestarts: int = 100,
                  tol: float = 1e-12) -> EigsResult:
    """Largest-magnitude eigenpair of a general operator (restarted
    Arnoldi, at least one restart). The eigenvalue is a host number, real
    for a real operator."""
    x, theta, resid, it = v0, 0.0, float("inf"), 0
    while it < maxrestarts and (it < 1 or resid > tol):
        V, H, nvalid = arnoldi_factorize(matvec, x, m)
        theta, z = small_eig_dominant(H[:m, :m], nvalid)
        x = basis_combine(V[:m], torch.as_tensor(z, device=V.device))
        x = x / torch.clamp(norm(x), min=_BREAKDOWN)
        last = min(max(nvalid - 1, 0), m - 1)
        resid = (0.0 if nvalid < m else
                 float(abs(H[last + 1, last] * z[last])
                       / max(abs(theta), _BREAKDOWN)))
        it += 1
    return EigsResult(theta, x, resid, it, resid <= tol)


def _host_eig_smallest_real(Hm, nvalid: int):
    """Ritz pair with the smallest real part of the leading nvalid block of
    a small host matrix, the vector phase-fixed so that its largest entry
    is real; returned zero-padded to length m, in complex128."""
    m = Hm.shape[0]
    n = max(int(nvalid), 1)
    w, V = np.linalg.eig(np.asarray(Hm, np.complex128)[:n, :n])
    idx = int(np.argmin(w.real))
    z = V[:, idx]
    k = int(np.argmax(np.abs(z)))
    z = z * (np.abs(z[k]) / z[k] if z[k] != 0 else 1.0)
    out = np.zeros(m, np.complex128)
    out[:n] = z
    return complex(w[idx]), out


def smallest_eigs_arnoldi(matvec: Callable, v0, m: int = 30,
                          maxrestarts: int = 100,
                          tol: float = 1e-12) -> EigsResult:
    """Smallest-real-part eigenpair of a general (non-Hermitian) operator
    by restarted Arnoldi (at least one restart), the Ritz selection on the
    host. The eigenvalue is a host number: complex for a complex operator,
    its real part for a real one (as the JAX package casts it)."""
    x, theta, resid, it = v0, 0.0, float("inf"), 0
    while it < maxrestarts and (it < 1 or resid > tol):
        V, H, nvalid = arnoldi_factorize(matvec, x, m)
        theta, z = _host_eig_smallest_real(H[:m, :m], nvalid)
        if not v0.is_complex():
            z = z.real
        x = basis_combine(V[:m], torch.as_tensor(z, device=V.device))
        x = x / torch.clamp(norm(x), min=_BREAKDOWN)
        last = min(max(nvalid - 1, 0), m - 1)
        resid = (0.0 if nvalid < m else
                 float(abs(H[last + 1, last] * z[last])
                       / max(abs(theta), _BREAKDOWN)))
        if not v0.is_complex():
            theta = theta.real
        it += 1
    return EigsResult(theta, x, resid, it, resid <= tol)
