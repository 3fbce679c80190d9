"""Fixed-point solver wrapper with convergence and uniqueness warnings
(counterpart of mpskit_tpu/linalg/fixedpoint.py).

The hot solves of the drivers return `converged`/`residual` flags that
the drivers aggregate (IterLog.solver_warn); this module is the host-side
wrapper for one solve, and the uniqueness check that the boundary driver
runs once at convergence. A magnitude-degenerate top pair of the small
Rayleigh-Ritz spectrum is the unsplittable-Schur-block condition of the
reference's check (complex conjugate pairs and true degeneracies both have
equal magnitude); a true multiplicity, which one Krylov run cannot see, is
caught by two runs from independent seeds.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..transfermatrix.transfer import transfer_left_mpo
from ..utils.logging import logger
from ..utils.tree import inner, norm
from .arnoldi import dominant_eigs, spectrum_arnoldi
from .lanczos import eigsh_smallest


def dominant_gap(matvec: Callable, x0, m: int = 20):
    """Top-2 eigenvalues (by magnitude) of `matvec` from one m-step Arnoldi
    factorization seeded at x0 (ideally the converged fixed point, so the
    second Ritz value is accurate). Returns (lam1, lam2) complex numbers."""
    w, _ = spectrum_arnoldi(matvec, x0, m, nev=2)
    return complex(w[0]), complex(w[1])


def _pseudo_seed(x, freq: float):
    """Deterministic generic start vector of x's shape, dtype and device:
    sin(freq k + 0.3 freq) over the flat index k = 1..n (real even for a
    complex x), the same numbers as the JAX package's; distinct `freq`
    give independent directions."""
    k = torch.arange(1, x.numel() + 1, dtype=torch.float64, device=x.device)
    return torch.sin(freq * k + 0.3 * freq).reshape(x.shape).to(x.dtype)


def uniqueness_warning(matvec: Callable, x, m: int = 20,
                       rel_gap_tol: float = 1e-3,
                       name: str = "fixedpoint") -> bool:
    """Warn when the dominant fixed point of `matvec` is non-unique, and
    return True then: (a) the top two Ritz values of one m-step
    factorization from x agree in magnitude to `rel_gap_tol`; or (b) two
    restarted Arnoldi runs from independent seeds agree on the eigenvalue
    but not on the eigenvector (overlap < 0.99: a degenerate eigenspace,
    e.g. the symmetry-broken low-temperature Ising boundary). Costs one
    factorization and two restarted solves."""
    lam1, lam2 = dominant_gap(matvec, x, m)
    a1, a2 = abs(lam1), abs(lam2)
    if a1 <= 0.0:
        return False
    rel_gap = (a1 - a2) / a1
    if rel_gap < rel_gap_tol:
        logger.warning(
            "%s: non-unique fixed point detected: dominant transfer "
            "eigenvalues |%.6e| and |%.6e| are degenerate to relative gap "
            "%.2e (< %.0e): the boundary state may mix symmetry-broken / "
            "rotated sectors", name, a1, a2, rel_gap, rel_gap_tol)
        return True

    r1 = dominant_eigs(matvec, _pseudo_seed(x, 0.7), m, 50, 1e-8)
    r2 = dominant_eigs(matvec, _pseudo_seed(x, 2.3), m, 50, 1e-8)
    l1, l2 = complex(r1.eigenvalue), complex(r2.eigenvalue)
    if abs(l1) <= 0.0:
        return False
    if abs(l1 - l2) / abs(l1) < 10 * rel_gap_tol:
        ov = abs(complex(inner(r1.eigenvector, r2.eigenvector)))
        ov /= max(float(norm(r1.eigenvector)) * float(norm(r2.eigenvector)),
                  1e-300)
        if ov < 0.99:
            logger.warning(
                "%s: non-unique fixed point detected: two independent "
                "Arnoldi runs agree on the dominant eigenvalue (%.6e) but "
                "converge to different fixed points (overlap %.4f): "
                "degenerate eigenspace (symmetry-broken sectors)", name,
                abs(l1), ov)
            return True
    return False


def transfer_uniqueness_warning(psi, Os, tol: float = 1e-9,
                                name: str = "leading_boundary",
                                m: int = 20) -> bool:
    """`uniqueness_warning` on the <psi| O |psi> channel transfer of one
    unit cell; Os is the stacked (L, w, w, d, d) device tensor of the
    boundary drivers."""
    L, D, w = psi.period, psi.D, Os.shape[1]

    def mv(v):
        for i in range(L):
            v = transfer_left_mpo(v, Os[i], psi.AL[i], psi.AL[i])
        return v

    eye = torch.eye(D, dtype=psi.dtype, device=psi.device)
    # a generic perturbation keeps a second eigenvector component in the
    # start vector even when the identity-like start is near the fixed point
    v0 = eye[None].expand(w, D, D) + 1e-3 * torch.ones(
        (w, D, D), dtype=psi.dtype, device=psi.device)
    rel_gap_tol = max(1e-3, float(tol) ** 0.5)
    return uniqueness_warning(mv, v0, m=min(m, 30), rel_gap_tol=rel_gap_tol,
                              name=name)


def fixedpoint(matvec: Callable, x0, which: str = "LM", m: int = 30,
               maxrestarts: int = 100, tol: float = 1e-12,
               name: str = "fixedpoint", verbosity: int = 1,
               check_unique: bool = True):
    """(val, vec) of `matvec`: `which` "SR" is the smallest-real Hermitian
    Lanczos, "LM" the largest-magnitude Arnoldi; warns on non-convergence,
    and for "LM" on a non-unique fixed point."""
    if which.upper() == "SR":
        res = eigsh_smallest(matvec, x0, m, maxrestarts, tol)
    elif which.upper() == "LM":
        res = dominant_eigs(matvec, x0, m, maxrestarts, tol)
    else:
        raise ValueError(f"which must be 'SR' or 'LM', got {which!r}")
    if verbosity >= 1 and not bool(res.converged):
        logger.warning("%s: not converged after %d restarts: normres = %.4e",
                       name, int(res.iterations), float(res.residual))
    if verbosity >= 1 and which.upper() == "LM" and check_unique:
        uniqueness_warning(matvec, res.eigenvector, m=min(m, 30), name=name)
    return res.eigenvalue, res.eigenvector
