"""Arnoldi for the dominant (largest-magnitude), the dominant near-real and
the smallest-real-part eigenpair of a general operator, and small full
spectra (counterpart of mpskit_tpu/linalg/arnoldi.py): the transfer-matrix
fixed points of the uniform gauge fix and of the statmech boundaries, the
boundary's local eigensolves, and the non-Hermitian quasiparticle solve.

`arnoldi_factorize` runs a fixed number of steps with no data-dependent
exit, so its Hessenberg matrix stays on the device and is read once, at the
end. Every small Hessenberg eigenproblem is then solved on the host in
float64 (complex128 for a complex operator) numpy; only the m Ritz
coefficients travel back to the device.

The dominant Ritz pair is LAPACK's `eig` on the leading valid block, where
the JAX package runs a fixed 300-step power iteration on the device. At a
critical transfer operator the power iteration stops short of the Ritz
vector while the residual estimate, computed from that vector, reads
converged; the exact solve has no such gap (ROADMAP.md, deliberate
differences). A real Hessenberg matrix whose top Ritz value is a complex
conjugate pair keeps the JAX power iteration, so that a real operator keeps
a real restart vector. The real selection, the smallest-real-part
selection and the full spectra are LAPACK's `eig` too, where the JAX
package reaches it through a host callback.
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


def _power_iteration(Hm, nvalid: int, iters: int = 300):
    """The JAX package's dominant Ritz pair: power iteration with a
    Rayleigh-quotient eigenvalue on the leading nvalid block, from its
    deterministic generic start vector."""
    m = Hm.shape[0]
    mask = np.arange(m) < nvalid
    Hm = np.where(mask[:, None] & mask[None, :], Hm, 0.0)
    z = np.where(mask, 1.0 + 0.1 * np.arange(m), 0.0).astype(Hm.dtype)
    z = z / np.linalg.norm(z)
    for _ in range(iters):
        z = Hm @ z
        z = z / max(np.linalg.norm(z), _BREAKDOWN)
    return np.vdot(z, Hm @ z), z


def small_eig_dominant(Hm, nvalid: int):
    """Dominant (largest-magnitude) eigenpair of a small (m, m) host matrix
    on its leading nvalid block, by LAPACK's `eig`: the unit Ritz vector
    zero-padded to length m, its phase fixed so that its overlap with the
    power iteration's start vector is real and positive (the sign the
    power iteration picks on a positive dominant eigenvalue). A real
    matrix whose top Ritz value is a complex pair keeps the power
    iteration (`_power_iteration`): no real eigenvector exists there."""
    m = Hm.shape[0]
    n = max(int(nvalid), 1)
    w, V = np.linalg.eig(Hm[:n, :n])
    idx = int(np.argmax(np.abs(w)))
    real = not np.iscomplexobj(Hm)
    if real and w[idx].imag != 0.0:
        return _power_iteration(Hm, nvalid)
    z = V[:, idx]
    theta = w[idx]
    if real:
        z, theta = z.real, theta.real
    ov = np.vdot(1.0 + 0.1 * np.arange(n), z)
    if ov != 0:
        z = z * (abs(ov) / ov)
    out = np.zeros(m, z.dtype)
    out[:n] = z / np.linalg.norm(z)
    return theta, out


class EigsResult(NamedTuple):
    eigenvalue: complex
    eigenvector: torch.Tensor
    residual: float
    iterations: int
    converged: bool


def _restarted(select: Callable, matvec: Callable, v0, m: int,
               maxrestarts: int, tol: float) -> EigsResult:
    """Restarted Arnoldi (at least one restart) with the Ritz pair that
    `select(Hm, nvalid)` picks from each factorization's host Hessenberg
    matrix. For a real operator the Ritz vector and the eigenvalue keep
    their real parts (as the JAX package casts them)."""
    x, theta, resid, it = v0, 0.0, float("inf"), 0
    while it < maxrestarts and (it < 1 or resid > tol):
        V, H, nvalid = arnoldi_factorize(matvec, x, m)
        theta, z = select(H[:m, :m], nvalid)
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


def dominant_eigs(matvec: Callable, v0, m: int = 30, maxrestarts: int = 100,
                  tol: float = 1e-12) -> EigsResult:
    """Largest-magnitude eigenpair of a general operator (restarted
    Arnoldi, at least one restart). The eigenvalue is a host number, real
    for a real operator."""
    return _restarted(small_eig_dominant, matvec, v0, m, maxrestarts, tol)


def _phase_fixed(w, V, idx: int, m: int, n: int):
    """Ritz pair idx, the vector phase-fixed so that its largest entry is
    real, zero-padded to length m, in complex128."""
    z = V[:, idx]
    k = int(np.argmax(np.abs(z)))
    z = z * (np.abs(z[k]) / z[k] if z[k] != 0 else 1.0)
    out = np.zeros(m, np.complex128)
    out[:n] = z
    return complex(w[idx]), out


def _host_eig_smallest_real(Hm, nvalid: int):
    """Ritz pair with the smallest real part of the leading nvalid block of
    a small host matrix."""
    m = Hm.shape[0]
    n = max(int(nvalid), 1)
    w, V = np.linalg.eig(np.asarray(Hm, np.complex128)[:n, :n])
    return _phase_fixed(w, V, int(np.argmin(w.real)), m, n)


def _host_eig_real_select(Hm, nvalid: int):
    """Dominant (near-)real Ritz pair of the leading nvalid block: among
    Ritz values with |imag| <= 1e-3 |value|, the largest magnitude weighted
    by 0.1 + the overlap with the restart vector (Krylov basis vector 0),
    which tracks the physical fixed point near convergence even when
    another real mode is transiently larger; the plain dominant pair when
    no Ritz value is near-real."""
    m = Hm.shape[0]
    n = max(int(nvalid), 1)
    w, V = np.linalg.eig(np.asarray(Hm, np.complex128)[:n, :n])
    realish = np.abs(w.imag) <= 1e-3 * np.maximum(np.abs(w), 1e-300)
    if realish.any():
        cand = np.where(realish, np.abs(w) * (0.1 + np.abs(V[0, :])), -1.0)
        idx = int(np.argmax(cand))
    else:
        idx = int(np.argmax(np.abs(w)))
    return _phase_fixed(w, V, idx, m, n)


def smallest_eigs_arnoldi(matvec: Callable, v0, m: int = 30,
                          maxrestarts: int = 100,
                          tol: float = 1e-12) -> EigsResult:
    """Smallest-real-part eigenpair of a general (non-Hermitian) operator
    by restarted Arnoldi (at least one restart), the Ritz selection on the
    host. The eigenvalue is a host number: complex for a complex operator,
    its real part for a real one (as the JAX package casts it)."""
    return _restarted(_host_eig_smallest_real, matvec, v0, m, maxrestarts,
                      tol)


def dominant_eigs_real(matvec: Callable, v0, m: int = 30,
                       maxrestarts: int = 100,
                       tol: float = 1e-12) -> EigsResult:
    """Largest-magnitude (near-)real eigenpair of a general operator, for
    transfer operators whose spurious complex rotation modes sit above the
    physical fixed point (`_host_eig_real_select`); restarted Arnoldi with
    the selection on the host."""
    return _restarted(_host_eig_real_select, matvec, v0, m, maxrestarts, tol)


def hessenberg_spectrum(Hm) -> np.ndarray:
    """All eigenvalues of a small host matrix, complex128, by descending
    magnitude (LAPACK)."""
    w = np.linalg.eigvals(np.asarray(Hm, np.complex128))
    return np.ascontiguousarray(w[np.argsort(-np.abs(w))])


def spectrum_arnoldi(matvec: Callable, v0, m: int = 30, nev: int = 5):
    """Approximate top-nev eigenvalues (by magnitude) of a general
    operator: one unrestarted m-step Arnoldi factorization and the host
    spectrum of its Hessenberg block. Returns (eigenvalues (nev,) complex128
    numpy, nvalid); eigenvalues beyond the valid block are exactly 0 and
    sort last."""
    _, H, nvalid = arnoldi_factorize(matvec, v0, m)
    mask = np.arange(m) < nvalid
    Hm = np.where(mask[:, None] & mask[None, :], H[:m, :m], 0.0)
    return hessenberg_spectrum(Hm)[:nev], nvalid
