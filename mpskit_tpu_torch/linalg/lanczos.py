"""Restarted Lanczos for the smallest eigenpair of a Hermitian operator
(counterpart of mpskit_tpu/linalg/lanczos.py).

The JAX package runs every loop of this module on the device
(`fori_loop`, `while_loop`, `cond`). PyTorch runs eagerly, so the loops
are host loops and each data-dependent exit reads device scalars through
`utils.sync.to_host`: one read per Lanczos step (its alpha and beta
together), one per convergence probe, one per full-reorthogonalization
factorization. The m x m tridiagonal Ritz problem is solved explicitly on
the host, in float64 numpy, from those same alpha/beta values: they are
on the host already for the exit tests, so this costs no further sync,
and only the m Ritz coefficients travel back to the device.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils.sync import to_host
from ..utils.trace import span
from ..utils.tree import add, inner, norm
from .basis import basis_combine, basis_inner_all, basis_zeros

_BREAKDOWN = 1e-14


def _sentinel(dtype):
    """Large value placed on invalid tridiagonal entries so they sort above
    any physical eigenvalue (same values as the JAX package)."""
    return 1e8 if dtype in (torch.float32, torch.complex64) else 1e30


def _normalized_or_zero(w, b):
    """w / b, or zeros after a breakdown (b <= _BREAKDOWN); no host sync."""
    s = torch.where(b > _BREAKDOWN, 1.0 / torch.clamp(b, min=_BREAKDOWN),
                    torch.zeros_like(b))
    return w * s


def _nvalid(beta, thresh):
    """Steps before the first breakdown (beta <= thresh), counting it."""
    broke = np.nonzero(beta <= thresh)[0]
    return int(broke[0]) + 1 if broke.size else beta.shape[0]


def _breakdown(alpha, beta, dtype) -> float:
    """The breakdown threshold of a factorization: _BREAKDOWN, raised in
    single precision to 10 eps |T| (the rounding level of a new Krylov
    vector). Once the Krylov space is exhausted (a masked sector smaller
    than m) the next beta is rounding noise: 1e-7 |H| in float32, far
    above _BREAKDOWN, and the normalized noise vectors that follow put
    spurious Ritz values into T (a float32 U(1) sweep at D=128 found
    -140 for an operator whose spectrum starts at -20)."""
    if dtype not in (torch.float32, torch.complex64):
        return _BREAKDOWN
    scale = max(float(np.abs(alpha).max()), float(np.abs(beta).max()))
    return max(_BREAKDOWN, 10 * float(torch.finfo(torch.float32).eps) * scale)


def lanczos_factorize(matvec: Callable, v0, m: int):
    """m Lanczos steps from v0 with two-pass classical Gram-Schmidt against
    the whole (m + 1)-slot stacked basis.

    Returns (V, alpha, beta, nvalid): V the device basis, alpha and beta
    float64 numpy arrays of length m (beta[j] connects j and j+1), nvalid
    the steps before breakdown."""
    v = v0 / torch.clamp(norm(v0), min=_BREAKDOWN)
    V = basis_zeros(v, m + 1)
    V[0] = v
    a_dev, b_dev = [], []
    for j in range(m):
        w = matvec(V[j])
        c1 = basis_inner_all(V, w)
        w = add(w, basis_combine(V, c1), alpha=-1.0)
        c2 = basis_inner_all(V, w)
        w = add(w, basis_combine(V, c2), alpha=-1.0)
        b = norm(w)
        a_dev.append((c1[j] + c2[j]).real)
        b_dev.append(b)
        V[j + 1] = _normalized_or_zero(w, b)
    ab = np.asarray(to_host(*a_dev, *b_dev), np.float64)
    alpha, beta = ab[:m], ab[m:]
    return V, alpha, beta, _nvalid(beta, _breakdown(alpha, beta, V.dtype))


def lanczos_factorize_local(matvec: Callable, v0, m: int,
                            corrective: bool = True, exit_tol: float = 0.0,
                            w0=None, use_w0: bool = False):
    """Lanczos with local reorthogonalization only: the 3-term recurrence,
    plus (corrective=True) one pass against the previous two vectors.

    exit_tol: stop once beta_j <= exit_tol (the restart's Ritz residual is
    bounded by beta_last). Each step reads its (alpha, beta) on the host
    for this test.

    w0/use_w0: a precomputed matvec(v0 / |v0|), consumed as step 0 when
    use_w0 is true (the caller's convergence probe already paid for it).
    Same return convention as `lanczos_factorize`."""
    v = v0 / torch.clamp(norm(v0), min=_BREAKDOWN)
    V = basis_zeros(v, m + 1)
    V[0] = v
    v_prev = torch.zeros_like(v)
    alpha = np.zeros(m)
    beta = np.zeros(m)

    def step(j, v_prev, v, w):
        b_prev = float(beta[j - 1]) if j > 0 else 0.0
        a = inner(v, w).real
        w = add(add(w, v, alpha=-a), v_prev, alpha=-b_prev)
        if corrective:
            da = inner(v, w)
            db = inner(v_prev, w)
            w = add(add(w, v, alpha=-da), v_prev, alpha=-db)
            a = a + da.real
        b = norm(w)
        wn = _normalized_or_zero(w, b)
        V[j + 1] = wn
        alpha[j], beta[j] = to_host(a, b)
        return v, wn

    j = 0
    if w0 is not None:
        v_prev, v = step(0, v_prev, v, w0 if use_w0 else matvec(v))
        j = 1
    while j < m and (j == 0 or beta[j - 1] > exit_tol):
        v_prev, v = step(j, v_prev, v, matvec(v))
        j += 1
    return V, alpha, beta, _nvalid(
        beta, max(_breakdown(alpha[:j], beta[:j], V.dtype), exit_tol))


def _tridiag(alpha, beta, nvalid: int, sentinel: float):
    """The m x m Rayleigh-Ritz matrix (float64 numpy); invalid slots are
    decoupled with the sentinel on the diagonal."""
    m = alpha.shape[0]
    idx = np.arange(m)
    a = np.where(idx < nvalid, alpha, sentinel)
    b = np.where(idx[:-1] < nvalid - 1, beta[:-1], 0.0)
    return np.diag(a) + np.diag(b, 1) + np.diag(b, -1)


class EigshResult(NamedTuple):
    eigenvalue: float
    eigenvector: torch.Tensor
    residual: float
    iterations: int
    converged: bool


def eigsh_smallest(matvec: Callable, v0, m: int = 30, maxrestarts: int = 100,
                   tol: float = 1e-12, reorth: str = "full",
                   matvec_fast: Callable = None) -> EigshResult:
    """Smallest-real eigenpair of a Hermitian operator via restarted Lanczos.

    reorth: "full" (two-pass CGS against the whole basis), "local" (3-term
    recurrence plus a corrective pass) or "local1" (3-term recurrence).

    matvec_fast: an optional inexact matvec (`derivatives.ac_apply_fast`).
    One accurate matvec first probes the start vector: if its residual
    meets tol the solve returns at once; if it is far from convergence
    (relative residual above 3e-2, well over the bf16 noise floor) the first
    restart builds its Krylov space with matvec_fast and an accurate
    restart polishes; otherwise every restart is accurate. Past the
    mandated restarts the solve stops once a restart no longer halves the
    residual (stagnation exit)."""
    with span("eigsh"):
        if maxrestarts < 2:
            matvec_fast = None  # no room for an accurate polish pass
        if reorth == "local":
            factorize = partial(lanczos_factorize_local, exit_tol=tol)
        elif reorth == "local1":
            factorize = partial(lanczos_factorize_local, corrective=False,
                                exit_tol=tol)
        elif reorth == "full":
            def factorize(mv, v, m, w0=None, use_w0=False):
                return lanczos_factorize(mv, v, m)
        else:
            raise ValueError(f"unknown reorth scheme {reorth!r}")

        if matvec_fast is None:
            x, lam, resid = v0, 0.0, float("inf")
            min_restarts = 1
        else:
            # quality probe: one accurate matvec on the normalized start
            x = v0 / torch.clamp(norm(v0), min=_BREAKDOWN)
            w0 = matvec(x)
            lam0 = inner(x, w0).real
            lam, resid = to_host(lam0, norm(add(w0, x, alpha=-lam0)))
            use_fast = resid > 3e-2 * max(abs(lam), 1e-30)
            min_restarts = 0 if resid <= tol else (2 if use_fast else 1)

        sentinel = _sentinel(v0.dtype)
        prev_resid = float("inf")
        it = 0
        while it < maxrestarts and (
                it < min_restarts
                or (resid > tol and (matvec_fast is None
                                     or resid < 0.5 * prev_resid))):
            if matvec_fast is None:
                V, alpha, beta, nvalid = factorize(matvec, x, m)
            else:
                # the probe's matvec(x) is step 0 of the first restart
                mv = matvec_fast if (it == 0 and use_fast) else matvec
                V, alpha, beta, nvalid = factorize(mv, x, m, w0=w0,
                                                   use_w0=(it == 0))
            evals, evecs = np.linalg.eigh(
                _tridiag(alpha, beta, nvalid, sentinel))
            s = evecs[:, 0]
            x = basis_combine(V[:m], torch.as_tensor(s, device=V.device))
            x = x / torch.clamp(norm(x), min=_BREAKDOWN)
            # residual bound beta_last * |s_last| on the valid block; it also
            # covers the tolerance-truncated factorizations (nvalid < m)
            last = min(max(nvalid - 1, 0), m - 1)
            prev_resid, resid = resid, float(abs(beta[last] * s[last]))
            lam = float(evals[0])
            it += 1
        return EigshResult(lam, x, resid, it, resid <= tol)


def tridiag_smallest(alpha, beta, nvalid: int, m: int):
    """Smallest eigenpair of the nvalid-masked symmetric tridiagonal Ritz
    matrix, invalid slots decoupled with the sentinel as in `_tridiag`.
    Returns (lam, s): lam a host float, s the (m,) eigenvector as a tensor
    of alpha's dtype and device (a numpy alpha gives a float64 CPU tensor),
    zero on the invalid slots, its sign fixed so that its entries sum to a
    positive number (the sign the JAX package's inverse iteration from a
    constant vector gives).

    The JAX package solves it on the device by Sturm bisection and inverse
    iteration (no LAPACK call inside its loops); here the m x m matrix is
    solved by float64 `torch.linalg.eigh` on the host, as `eigsh_smallest`
    solves its Ritz problem (ROADMAP.md, deliberate differences)."""
    a = torch.as_tensor(alpha)
    b = torch.as_tensor(beta)
    sentinel = _sentinel(a.dtype)
    T = _tridiag(a.detach().cpu().double().numpy()[:m],
                 b.detach().cpu().double().numpy()[:m], int(nvalid), sentinel)
    evals, evecs = torch.linalg.eigh(torch.from_numpy(T))
    s = evecs[:, 0] * (torch.arange(m) < nvalid)
    if float(s.sum()) < 0:
        s = -s
    return float(evals[0]), s.to(dtype=a.dtype, device=a.device)


def lanczos_groundstate(matvec: Callable, v0, m: int = 30,
                        maxrestarts: int = 100, tol: float = 1e-12):
    """(eigenvalue, eigenvector) of `eigsh_smallest`."""
    res = eigsh_smallest(matvec, v0, m, maxrestarts, tol)
    return res.eigenvalue, res.eigenvector
