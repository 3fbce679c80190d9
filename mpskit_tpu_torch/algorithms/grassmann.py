"""Riemannian gradient optimization over the Grassmann manifold of
left-isometric MPS tensors (counterpart of mpskit_tpu/algorithms/grassmann.py).

The tangent gradient is the local G_i = VL_i VL_i^dag (H^AC_i AC_i) C_i^dag,
preconditioned by the regularized density (C C^dag + delta)^-1 and
projected back onto the horizontal space; no autodiff runs. The solver is
Polak-Ribiere nonlinear CG with a QR retraction and a backtracking line
search. The JAX package vmaps the site gradient over the cell and scans
the finite chain's right densities; here both are host loops over the
sites. Every energy the line search compares is read on the host (one
read per evaluation), and each CG step reads its gradient norm and the
Polak-Ribiere numerator together.

The infinite solver measures convergence by the norm of the
preconditioned gradient, as the JAX package does. That norm does not
decay to zero at finite precision (the finite solver's comment below says
why), so a tight `tol` runs `maxiter` iterations (ROADMAP.md, known
reference-side defects).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import Defaults, VERBOSE_ITER, VERBOSE_WARN, matmul_precision
from ..environments.finite import (
    compute_left_envs, compute_right_envs, finite_environments, left_boundary,
    right_boundary, stack_W,
)
from ..environments.infinite_ham import hamiltonian_environments
from ..states.finitemps import FiniteMPS, support_mask
from ..states.infinitemps import InfiniteMPS
from ..tensors.ops import qr_pos
from ..utils.logging import IterLog, logger
from ..utils.sync import to_host
from .derivatives import ac_apply
from .unionalg import Chainable


@dataclasses.dataclass(frozen=True)
class GradientGrassmann(Chainable):
    """Same fields and defaults as mpskit_tpu.algorithms.grassmann."""

    tol: float = 1e-8
    maxiter: int = 300
    step0: float = 0.05
    verbosity: int = Defaults.verbosity


def _project(AL, x):
    """x - AL (AL^dag x): the horizontal part of x at AL (leading axes
    are a batch of sites)."""
    z = torch.einsum("...lpm,...lpk->...mk", AL.conj(), x)
    return x - torch.einsum("...lpm,...mk->...lpk", AL, z)


def _precondition(G, rho):
    """G (rho + delta)^-1 on the right bond, delta = 1e-12 + 1e-3 |G|^2
    (reference grassmann.jl:59-130)."""
    D = rho.shape[0]
    delta = 1e-12 + 1e-3 * torch.linalg.vector_norm(G) ** 2
    rho_reg = rho + delta * torch.eye(D, dtype=rho.dtype, device=rho.device)
    return torch.linalg.solve(rho_reg.mT, G.reshape(-1, D).mT).mT \
        .reshape(G.shape)


def _energy_and_gradient(psi: InfiniteMPS, H, env_tol: float,
                         env_guess=None):
    """(e_density 0-dim tensor, tangent gradient (L, D, d, D), envs).
    `env_guess` warm-starts the environment GMRES solves."""
    envs = hamiltonian_environments(psi, H, tol=env_tol, env_init=env_guess)
    Ws = stack_W(H, psi.period, psi.dtype, psi.device)
    grads = []
    for i in range(psi.period):
        y = ac_apply(envs.GLs[i], Ws[i], envs.GRs[i], psi.AC[i])
        C = psi.C[i]
        G = torch.einsum("lpr,mr->lpm", y, C.conj())   # d E / d AL*
        G = _precondition(G, C @ C.mH)
        grads.append(_project(psi.AL[i], G))
    return envs.e_density, torch.stack(grads), envs


def _retract(ALs, xi, alpha):
    """QR retraction AL <- qf(AL + alpha xi), batched over the cell."""
    L, D, d, _ = ALs.shape
    Q, _ = qr_pos((ALs + alpha * xi).reshape(L, D * d, D))
    return Q.reshape(L, D, d, D)


def _cg_beta(g_new, g, gnorm_prev):
    """Polak-Ribiere numerator <g_new, g_new - g> / max(|g|^2, 1e-30), a
    0-dim tensor (read with the new gradient norm)."""
    num = torch.vdot(g_new.reshape(-1), (g_new - g).reshape(-1)).real
    return num / max(gnorm_prev ** 2, 1e-30)


def find_groundstate_grassmann(psi: InfiniteMPS, H,
                               alg: GradientGrassmann = GradientGrassmann()):
    """Nonlinear CG over the AL Grassmann manifold. Returns
    (psi, envs, grad_norm)."""
    log = IterLog("GradGrassmann", alg.verbosity)
    with matmul_precision():
        e, g, env_guess = _energy_and_gradient(psi, H, 1e-12)
        e, gnorm_prev = to_host(e.real, torch.linalg.vector_norm(g))
        direction = -g
        alpha = alg.step0
        gnorm = gnorm_prev
        for it in range(1, alg.maxiter + 1):
            improved = False
            for _ in range(12):
                psi_new = InfiniteMPS.from_AL(_retract(psi.AL, direction,
                                                       alpha))
                e_dev, g_new, env_guess = _energy_and_gradient(
                    psi_new, H, 1e-12, env_guess=env_guess)
                e_new = to_host(e_dev.real)[0]
                if e_new < e + 1e-14:
                    improved = True
                    break
                alpha *= 0.5
            if not improved:
                break
            psi, e = psi_new, e_new
            gnorm, beta = to_host(torch.linalg.vector_norm(g_new),
                                  _cg_beta(g_new, g, gnorm_prev))
            if gnorm < alg.tol:
                break
            beta = max(0.0, beta)
            direction = -g_new + beta * _project(psi.AL, direction)
            g, gnorm_prev = g_new, gnorm
            alpha = min(alpha * 2.0, 1.0)
            if alg.verbosity >= VERBOSE_ITER:
                log.conv(it, e, gnorm)
            if alg.verbosity >= VERBOSE_WARN and env_guess.resid > 1e-6:
                logger.warning(
                    "GradGrassmann: iteration %d: environment GMRES residual "
                    "%.4e (not converged)", it, env_guess.resid)
        envs = hamiltonian_environments(psi, H, env_init=env_guess)
    return psi, envs, gnorm


# ----------------------------------------------------------------------------
# finite chains
# ----------------------------------------------------------------------------

def _energy_and_gradient_finite(Xs, Ws, mask):
    """Energy (0-dim real tensor), preconditioned horizontal gradient and
    the unpreconditioned one (the convergence measure and the restart
    direction) of a finite chain of left isometries Xs (L, D, d, D), site
    L-1 the normalized center; `mask` is the (L, D, d, D) support mask in
    the working dtype."""
    L, D = Xs.shape[0], Xs.shape[1]
    w = Ws.shape[1]
    dtype, device = Xs.dtype, Xs.device
    GLs = compute_left_envs(Xs, Ws, left_boundary(w, D, dtype, device))
    GRs = compute_right_envs(Xs, Ws, right_boundary(w, D, dtype, device))
    e = torch.vdot(Xs[0].reshape(-1),
                   ac_apply(GLs[0], Ws[0], GRs[1], Xs[0]).reshape(-1)).real
    # right densities rho_i at the right bond of site i: the identity
    # transfer of the chain from the right (the JAX reverse scan)
    rhos = torch.empty((L, D, D), dtype=dtype, device=device)
    rho = torch.eye(D, dtype=dtype, device=device)
    for i in range(L - 1, -1, -1):
        rhos[i] = rho
        rho = torch.einsum("lpm,mn,kpn->lk", Xs[i], rho, Xs[i].conj())
    grads, raws = [], []
    for i in range(L):
        X, mk = Xs[i], mask[i]
        G = ac_apply(GLs[i], Ws[i], GRs[i + 1], X)
        # subtract the norm-direction component e X rho: the chain
        # parametrizes the state directly
        G = G - e * torch.einsum("lpm,mn->lpn", X, rhos[i])
        raws.append(_project(X, G) * mk)
        grads.append(_project(X, _precondition(G, rhos[i])) * mk)
    return e, torch.stack(grads), torch.stack(raws)


def find_groundstate_grassmann_finite(psi: FiniteMPS, H,
                                      alg: GradientGrassmann =
                                      GradientGrassmann()):
    """Nonlinear CG over the product of finite-chain Grassmann manifolds.
    Returns (FiniteMPS, envs, grad_norm)."""
    log = IterLog("GradGrassmann", alg.verbosity)
    L, D, d = psi.length, psi.D, psi.physicaldim
    dtype, device = psi.dtype, psi.device
    p = psi.move_center(L - 1)
    Xs = p.ALs.clone()
    Xs[L - 1] = p.AC / torch.clamp(torch.linalg.vector_norm(p.AC), min=1e-30)
    Ws = stack_W(H, L, dtype, device)
    mask = torch.as_tensor(support_mask(L, d, D), device=device).to(dtype)

    def retract(Xs, xi, alpha):
        Q, _ = qr_pos((Xs + alpha * xi).reshape(L, -1, D))
        return Q.reshape(Xs.shape) * mask

    with matmul_precision():
        e, g, g_raw = _energy_and_gradient_finite(Xs, Ws, mask)
        e, gnorm_prev = to_host(e, torch.linalg.vector_norm(g))
        direction = -g
        is_steepest = True
        gnorm = gnorm_prev
        alpha = alg.step0
        for it in range(1, alg.maxiter + 1):
            improved = False
            for _ in range(12):
                Xs_new = retract(Xs, direction, alpha)
                e_dev, g_new, g_raw_new = _energy_and_gradient_finite(
                    Xs_new, Ws, mask)
                e_new = to_host(e_dev)[0]
                if e_new < e + 1e-14:
                    improved = True
                    break
                alpha *= 0.5
            if not improved:
                if is_steepest:
                    break
                # the CG direction stopped descending: restart from the raw
                # steepest descent before giving up
                direction = -g_raw
                is_steepest = True
                alpha = alg.step0
                continue
            Xs, e = Xs_new, e_new
            g_raw = g_raw_new
            gnorm, beta = to_host(torch.linalg.vector_norm(g_raw),
                                  _cg_beta(g_new, g, gnorm_prev))
            if gnorm < alg.tol:
                break
            beta = max(0.0, beta)
            direction = -g_new + beta * _project(Xs, direction) * mask
            is_steepest = beta == 0.0
            g, gnorm_prev = g_new, gnorm
            alpha = min(alpha * 2.0, 1.0)
            if alg.verbosity >= VERBOSE_ITER:
                log.conv(it, e, gnorm)
        psi = FiniteMPS.from_tensors(Xs)
        envs = finite_environments(psi, H)
    return psi, envs, gnorm
