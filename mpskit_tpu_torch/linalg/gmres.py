"""Restarted adaptive GMRES (counterpart of mpskit_tpu/linalg/gmres.py):
the geometric-series environment solves of the infinite path; and the
conjugate gradient `linsolve_cg` of `fidelity_susceptibility`.

The JAX package runs the Arnoldi cycle as a `lax.while_loop` whose exit
tests read the Givens-rotated least-squares residual on the device. Here
the cycle is a host loop: each Arnoldi step reads its new Hessenberg
column and subdiagonal norm in one `to_host_array` transfer (the exit test
needs them anyway), and the Givens update, the least-squares estimate and
the final back-substitution run on the host in float64 (complex128 for a
complex operator) numpy, as `lanczos.py` does for its Ritz solve. Only the
m solution coefficients travel back to the device. Every threshold keeps
the working dtype's eps, so a float32 solve stalls out where the JAX
package's does.

An open recording (utils/trace.py) counts each solve's operator
applications (the Arnoldi steps, the first residual and each cycle's true
residual) as `gmres_op` inside the solve's `gmres` span.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..utils.sync import to_host, to_host_array
from ..utils.trace import count, span
from ..utils.tree import add, norm
from .basis import basis_combine, basis_inner_all, basis_zeros

_TINY = 1e-30


def _givens(a, b_real: float):
    """Complex Givens rotation zeroing a real non-negative subdiagonal b
    under a (possibly complex) diagonal a: returns (c, s, r) with
    [c s; -conj(s) c] @ [a; b] = [r; 0], c real."""
    aa = abs(a)
    if aa <= _TINY:  # a == 0: swap rows
        return 0.0, 1.0, b_real
    t = math.hypot(aa, b_real)
    phase = a / aa
    return aa / t, phase * (b_real / t), phase * t


def _eps(x) -> float:
    """Machine eps of the working (real) dtype of tensor x."""
    return torch.finfo(x.real.dtype if x.is_complex() else x.dtype).eps


def _gmres_cycle_adaptive(op: Callable, r, beta: float, m: int,
                          exit_tol: float, passes: int = 1,
                          stall_exit: bool = False, stall_arm: float = 0.0):
    """One adaptive GMRES cycle: Arnoldi from r/beta with an incrementally
    Givens-rotated Hessenberg, so that the least-squares residual is known
    at every step; stops at `exit_tol` (absolute, on the LS estimate), at
    breakdown or after m steps. Returns (dx, est, steps).

    stall_exit also stops on a 4-step stall (< 5 % improvement a step),
    counted only once the estimate is below `stall_arm` (absolute): only
    safe for linearly convergent operators such as gapped geometric-series
    transfer solves, where such a plateau is the dtype floor (see the JAX
    docstring for the measured failures without either guard)."""
    v0 = r / max(beta, _TINY)
    V = basis_zeros(v0, m + 1)
    V[0] = v0
    hdt = np.complex128 if r.is_complex() else np.float64
    R = np.zeros((m + 1, m), hdt)   # rotated (triangular) columns
    Q = np.eye(m + 1, dtype=hdt)    # accumulated rotations
    max_stalls = 4 if stall_exit else m + 1
    j, est, stalls = 0, beta, 0
    while j < m and est > exit_tol and stalls < max_stalls:
        w = op(V[j])
        c1 = basis_inner_all(V, w)
        w = add(w, basis_combine(V, c1), alpha=-1.0)
        if passes > 1:
            c2 = basis_inner_all(V, w)
            w = add(w, basis_combine(V, c2), alpha=-1.0)
            c1 = c1 + c2
        hb_dev = norm(w)
        V[j + 1] = w * torch.where(hb_dev > _TINY,
                                   1.0 / torch.clamp(hb_dev, min=_TINY),
                                   torch.zeros_like(hb_dev))
        col = to_host_array(c1, hb_dev)
        hb = float(col[-1].real)
        # rotate the new column by all previous rotations at once (Q is the
        # accumulated product), then generate this step's rotation; entries
        # below j are zero already
        hcol = Q @ col[: m + 1].astype(hdt)
        gc, gs, gr = _givens(hcol[j], hb)
        hcol[j] = gr
        R[:, j] = hcol
        rowj, rowj1 = Q[j].copy(), Q[j + 1].copy()
        Q[j] = gc * rowj + gs * rowj1
        Q[j + 1] = -np.conj(gs) * rowj + gc * rowj1
        est_new = beta * abs(Q[j + 1, 0])
        if est_new < 0.95 * est:
            stalls = 0
        elif est_new < stall_arm:
            stalls += 1
        est = est_new
        j += 1

    # back-substitution on the leading j x j triangle; unfilled columns
    # are masked to the identity, and a diagonal floor at 100 eps of the
    # working dtype guards breakdown-step columns (as in the JAX package)
    colmask = np.arange(m) < j
    Rm = R[:m] * colmask[None, :] + np.diag((~colmask).astype(hdt))
    dmag = np.abs(np.diagonal(Rm))
    floor = 100 * _eps(r) * max(float(dmag.max()), _TINY)
    Rm = Rm + np.diag(np.where(dmag < floor, floor, 0.0))
    y = beta * Q[:m, 0] * colmask
    for i in range(m - 1, -1, -1):
        y[i] = y[i] / Rm[i, i]
        y[:i] -= Rm[:i, i] * y[i]
    y = y * colmask
    dx = basis_combine(V[:m], torch.as_tensor(y, device=r.device))
    return dx, est, j


def gmres_restarted(op: Callable, b, x0, tol: float, restart: int = 30,
                    maxiter: int = 40, stall_exit: bool = False):
    """Restarted adaptive GMRES with per-step and per-cycle exits.

    Each cycle is `_gmres_cycle_adaptive` from the current true residual.
    The outer loop stops at `tol` (relative to ||b||), at `maxiter` cycles,
    or after two consecutive cycles that fail to cut the true residual by
    30 %, counted once it is below the arming level 50 sqrt(N) eps of the
    working dtype. The cycle-end true residual (one matvec) seeds the next
    cycle; its norm, read once, serves as both the exit test and the next
    cycle's beta. Returns (x, relres, cycles), relres a host float."""
    n_tot = b.numel() or 1
    arm_rel = 50.0 * math.sqrt(n_tot) * _eps(b)
    r = add(b, op(x0), alpha=-1.0)
    n_ops = 1
    bnorm, rnorm = to_host(norm(b), norm(r))
    bnorm = max(bnorm, _TINY)
    abs_tol = tol * bnorm
    arm_abs = arm_rel * bnorm
    x, relres, it, stalls = x0, rnorm / bnorm, 0, 0
    while it < maxiter and relres > tol and stalls < 2:
        dx, _, steps = _gmres_cycle_adaptive(
            op, r, rnorm, restart, 0.5 * abs_tol, passes=1,
            stall_exit=stall_exit, stall_arm=arm_abs)
        x = add(x, dx)
        r = add(b, op(x), alpha=-1.0)
        n_ops += steps + 1
        rnorm = to_host(norm(r))[0]
        prev, relres = relres, rnorm / bnorm
        if relres < 0.7 * prev:
            stalls = 0
        elif relres < arm_rel:
            stalls += 1
        it += 1
    count("gmres_op", n_ops)
    return x, relres, it


def linsolve(matvec: Callable, b, x0=None, a0=1.0, a1=1.0, tol=1e-12,
             restart: int = 30, maxiter: int = 40):
    """Solve (a0 + a1 * A) x = b (KrylovKit's `linsolve(f, b, x0, a0, a1)`:
    a0=1, a1=-1 gives (1 - T) x = b)."""
    x, _ = linsolve_info(matvec, b, x0, a0, a1, tol, restart, maxiter)
    return x


def linsolve_info(matvec: Callable, b, x0=None, a0=1.0, a1=1.0, tol=1e-12,
                  restart: int = 30, maxiter: int = 40,
                  stall_exit: bool = False):
    """`linsolve` that also returns the true relative residual
    ||(a0 + a1 A) x - b|| / ||b|| as a host float. The JAX package spends
    one more matvec on it; here it is the norm that the last cycle of
    `gmres_restarted` read for its exit test, of the same residual."""
    with span("gmres"):
        if x0 is None:
            x0 = b

        def op(x):
            return add(a0 * x, matvec(x), alpha=a1)

        x, relres, _ = gmres_restarted(op, b, x0, tol, restart, maxiter,
                                       stall_exit=stall_exit)
        return x, relres


def _leaves(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _like(x, leaves):
    return leaves if isinstance(x, (list, tuple)) else leaves[0]


def _tree_inner(x, y):
    return sum(torch.vdot(a.reshape(-1), b.reshape(-1))
               for a, b in zip(_leaves(x), _leaves(y)))


def _tree_axpy(x, y, alpha):
    """x + alpha * y over a tensor or a list of tensors."""
    return _like(x, [a + alpha * b for a, b in zip(_leaves(x), _leaves(y))])


def linsolve_cg(matvec: Callable, b, x0=None, tol: float = 1e-10,
                maxiter: int = 200):
    """Conjugate gradient for a Hermitian positive (semi)definite operator
    on a tensor or a list of tensors (the QP tangent vectors of
    `fidelity_susceptibility`, whose operator itself runs GMRES
    environment solves). Stops once ||r|| <= tol * max(||b||, 1e-30) or
    after `maxiter` steps, the JAX package's rule; the host loop reads ||r||
    once per step. Returns x."""
    if x0 is None:
        x0 = _like(b, [torch.zeros_like(a) for a in _leaves(b)])
    bnorm = torch.sqrt(_tree_inner(b, b).real)
    x = x0
    r = _tree_axpy(b, matvec(x0), -1.0)
    p = r
    rs = _tree_inner(r, r)
    k = 0
    while k < maxiter:
        rnorm, bn = to_host(torch.sqrt(rs.real), bnorm)
        if rnorm <= tol * max(bn, 1e-30):
            break
        Ap = matvec(p)
        alpha = rs / _tree_inner(p, Ap)
        x = _tree_axpy(x, p, alpha)
        r = _tree_axpy(r, Ap, -alpha)
        rs_new = _tree_inner(r, r)
        p = _tree_axpy(r, p, rs_new / rs)
        rs = rs_new
        k += 1
    return x
