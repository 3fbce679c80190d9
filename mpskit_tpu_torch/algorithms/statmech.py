"""Statistical-mechanics boundaries (counterpart of
mpskit_tpu/algorithms/statmech.py): `leading_boundary` of a transfer MPO
(a 2D partition function) by boundary VUMPS, VOMPS or GradientGrassmann,
on one row or on a multi-row MPSMultiline / MPOMultiline.

The local solves maximize the dominant eigenvalue, so they are restarted
Arnoldi (largest magnitude) instead of Lanczos. The JAX package runs one
iteration as one jit-compiled function with the per-site solves vmapped
over the unit cell; here an iteration is a sequence of host-driven steps:
the channel environments (two Arnoldi fixed points), a host loop over the
sites for the AC and C solves (each site's output written to its seat),
one batched regauge and the gauge fix `InfiniteMPS.from_AL`. The anyonic
boundaries (symmetry/fibonacci.py) pass static sector masks: the local
solves then run in the masked Krylov space, the environments in theirs,
and the new AR is built locally from (C_{i-1}, AC_i) in place of the gauge
fix.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import Defaults, VERBOSE_ITER, matmul_precision
from ..environments.infinite_mpo import mpo_environments, stack_O
from ..linalg.arnoldi import dominant_eigs, dominant_eigs_real
from ..linalg.fixedpoint import transfer_uniqueness_warning
from ..operators.multiline import MPOMultiline
from ..states.gauging import regauge_ACC, regauge_CAC
from ..states.infinitemps import InfiniteMPS
from ..states.multiline import MPSMultiline
from ..utils.dynamictols import updatetol
from ..utils.logging import IterLog, logger
from ..utils.sync import to_host
from .derivatives import ac_apply, c_apply

@dataclasses.dataclass(frozen=True)
class VUMPS_Boundary:
    tol: float = 1e-10
    maxiter: int = Defaults.maxiter
    krylovdim: int = Defaults.krylovdim
    gauge_tol: float = Defaults.tolgauge
    verbosity: int = Defaults.verbosity


@dataclasses.dataclass(frozen=True)
class VOMPS:
    """Power-method boundary update: one MPO application per iteration in
    place of the local eigensolves."""

    tol: float = 1e-9
    maxiter: int = 500
    gauge_tol: float = Defaults.tolgauge
    verbosity: int = Defaults.verbosity


def _mask_as(M, like):
    """A static mask (boolean array or tensor) as a tensor of `like`'s
    dtype on its device; None stays None."""
    if M is None:
        return None
    return torch.as_tensor(M, device=like.device).to(like.dtype)


def _solve_acs(envs, Os, ACs, m: int, tol: float, Am=None, real=False):
    """Dominant eigenvector of each site's AC channel operator, started
    from the current AC. With masks Am (L, D, d, D) the operator is
    Am_i * T(Am_i * x), the Krylov space confined to the sector, and
    `real` selects the dominant real pair (`dominant_eigs_real`). Returns
    (ACs', converged flags, residuals)."""
    solver = dominant_eigs_real if real else dominant_eigs
    out, conv, resid = [], [], []
    for i in range(ACs.shape[0]):
        GL, O, GR = envs.GLs[i], Os[i], envs.GRs[i]
        if Am is None:
            res = solver(lambda x: ac_apply(GL, O, GR, x), ACs[i], m, 20,
                         tol)
        else:
            Mi = Am[i]
            res = solver(lambda x: Mi * ac_apply(GL, O, GR, Mi * x), ACs[i],
                         m, 20, tol)
        out.append(res.eigenvector)
        conv.append(res.converged)
        resid.append(res.residual)
    return torch.stack(out), conv, resid


def _solve_cs(envs, Cs, m: int, tol: float, Cm=None, real=False):
    """The same for each bond's C: bond i uses (GLs[i+1], GRs[i])."""
    solver = dominant_eigs_real if real else dominant_eigs
    L = Cs.shape[0]
    out, conv, resid = [], [], []
    for i in range(L):
        GL, GR = envs.GLs[(i + 1) % L], envs.GRs[i]
        if Cm is None:
            res = solver(lambda x: c_apply(GL, GR, x), Cs[i], m, 20, tol)
        else:
            Mi = Cm[i]
            res = solver(lambda x: Mi * c_apply(GL, GR, Mi * x), Cs[i], m,
                         20, tol)
        out.append(res.eigenvector)
        conv.append(res.converged)
        resid.append(res.residual)
    return torch.stack(out), conv, resid


def _boundary_regauge(ACs, Cs, Am=None):
    """AL_i = argmin |AC_i - AL C_i| (batched QRpos, re-masked by Am) and
    the convergence measure eps = max_i |AC_i - phase_i AL_i C_i|, the
    global phase of each site removed (a 0-dim tensor)."""
    L = ACs.shape[0]
    ALs = regauge_ACC(ACs, Cs)
    if Am is not None:
        ALs = ALs * Am
    ALC = torch.einsum("ilpm,imr->ilpr", ALs, Cs)
    phase = torch.einsum("ilpr,ilpr->i", ALC.conj(), ACs)
    phase = phase / torch.clamp(phase.abs(), min=1e-30)
    eps = torch.linalg.vector_norm(
        (ACs - phase[:, None, None, None] * ALC).reshape(L, -1), dim=1).max()
    return ALs, eps


def _masked_state(ALs, ACs, Cs, Am, Cm):
    """The masked path's new state: AR_i built locally from (C_{i-1},
    AC_i) by LQpos in place of the gauge fix (whose fixed-point eigensolves
    rotate the bond basis within near-degenerate sectors, against the
    static masks), everything re-masked."""
    ARs = regauge_CAC(torch.roll(Cs, 1, dims=0), ACs)
    return InfiniteMPS(ALs * Am, ARs * Am, ACs * Am, Cs * Cm)


def _normalized(X):
    """Each site's tensor of the stacked X scaled to unit norm."""
    n = torch.linalg.vector_norm(X.reshape(X.shape[0], -1), dim=1)
    return X / n.reshape((-1,) + (1,) * (X.dim() - 1))


def _boundary_vumps_iteration(psi: InfiniteMPS, Os, m: int, gauge_tol: float,
                              env_tol: float, inner_tol: float = 1e-6,
                              GL_guess=None, GR_guess=None, A_mask=None,
                              C_mask=None, env_mask=None):
    """One boundary VUMPS iteration. Returns (psi', eps 0-dim tensor, GL of
    site 0, GR of site L-1 (the next iteration's environment guesses), diag
    the host triple (# unconverged local solves, worst local residual,
    environment residual)).

    Sector masks (A_mask (L, D, d, D), C_mask (L, D, D), env_mask (w, D,
    D); the anyonic boundaries of symmetry/fibonacci.py) confine each
    Krylov space to its sector: a largest-magnitude solve could otherwise
    converge onto a spurious mixed-sector vector that masking afterwards
    destroys. With env_mask the solves select the dominant real pair."""
    L = psi.period
    envs = mpo_environments(psi, Os, tol=env_tol, krylovdim=m,
                            GL0=GL_guess, GR0=GR_guess, env_mask=env_mask,
                            select_real=env_mask is not None)
    Am, Cm = _mask_as(A_mask, psi.AC), _mask_as(C_mask, psi.C)
    real = Am is not None and env_mask is not None
    ACs, conv_a, res_a = _solve_acs(envs, Os, psi.AC, m, inner_tol, Am, real)
    Cs, conv_c, res_c = _solve_cs(envs, psi.C, m, inner_tol, Cm, real)
    diag = (sum(not c for c in conv_a + conv_c), max(res_a + res_c),
            envs.resid)
    if Am is None:
        ALs, eps = _boundary_regauge(ACs, Cs)
        psi_new = InfiniteMPS.from_AL(ALs, psi.C[L - 1], tol=gauge_tol)
    else:
        ACs, Cs = ACs * Am, Cs * Cm
        ALs, eps = _boundary_regauge(ACs, Cs, Am)
        psi_new = _masked_state(ALs, ACs, Cs, Am, Cm)
    return psi_new, eps, envs.GLs[0], envs.GRs[L - 1], diag


def _boundary_vomps_iteration(psi: InfiniteMPS, Os, gauge_tol: float,
                              env_tol: float, GL_guess=None, GR_guess=None,
                              A_mask=None, C_mask=None, env_mask=None):
    """One power-method step: a single channel application per site in
    place of the eigensolves, with the sector masks of
    `_boundary_vumps_iteration`. Returns (psi', eps, GL0, GR_{L-1},
    environment residual)."""
    L = psi.period
    envs = mpo_environments(psi, Os, tol=env_tol, GL0=GL_guess, GR0=GR_guess,
                            env_mask=env_mask,
                            select_real=env_mask is not None)
    ACs = torch.stack([ac_apply(envs.GLs[i], Os[i], envs.GRs[i], psi.AC[i])
                       for i in range(L)])
    Cs = torch.stack([c_apply(envs.GLs[(i + 1) % L], envs.GRs[i], psi.C[i])
                      for i in range(L)])
    Am, Cm = _mask_as(A_mask, psi.AC), _mask_as(C_mask, psi.C)
    if Am is not None:
        ACs, Cs = ACs * Am, Cs * Cm
    ACs, Cs = _normalized(ACs), _normalized(Cs)
    ALs, eps = _boundary_regauge(ACs, Cs, Am)
    if Am is None:
        psi_new = InfiniteMPS.from_AL(ALs, psi.C[L - 1], tol=gauge_tol)
    else:
        psi_new = _masked_state(ALs, ACs, Cs, Am, Cm)
    return psi_new, eps, envs.GLs[0], envs.GRs[L - 1], envs.resid


def _boundary_value_and_gradient(psi: InfiniteMPS, Os, env_tol: float,
                                 GL0=None, GR0=None):
    """Free energy f = -(1/L) sum_i log|lambda_i| (a 0-dim tensor) and its
    preconditioned tangent gradient over the AL Grassmann manifold, with
    the environments taken as self-consistent fixed points: the local
    derivative -(T^AC AC) C^dag / conj(lambda), preconditioned by inv(rho)
    and projected horizontally (zero at the VUMPS fixed point). Returns
    (f, grads (L, D, d, D), GL0, GR_{L-1})."""
    from .grassmann import _precondition, _project

    L = psi.period
    envs = mpo_environments(psi, Os, tol=env_tol, GL0=GL0, GR0=GR0)
    lams, grads = [], []
    for i in range(L):
        AC, C = psi.AC[i], psi.C[i]
        y = ac_apply(envs.GLs[i], Os[i], envs.GRs[i], AC)
        lam = torch.vdot(AC.reshape(-1), y.reshape(-1))   # Rayleigh quotient
        G = -torch.einsum("lpr,mr->lpm", y, C.conj()) / lam.conj()
        grads.append(_project(psi.AL[i], _precondition(G, C @ C.mH)))
        lams.append(lam)
    f = -torch.sum(torch.log(torch.stack(lams).abs())) / L
    return f, torch.stack(grads), envs.GLs[0], envs.GRs[L - 1]


def _leading_boundary_grassmann(psi: InfiniteMPS, Os, alg):
    """Riemannian conjugate-gradient maximization of the leading transfer
    eigenvalue: Polak-Ribiere CG with the QR retraction of
    `grassmann._retract` and a 12-halving backtracking line search."""
    from .grassmann import _cg_beta, _project, _retract

    log = IterLog("GradGrassmann", alg.verbosity)
    f, g, GLg, GRg = _boundary_value_and_gradient(psi, Os, 1e-12)
    f, gnorm_prev = to_host(f, torch.linalg.vector_norm(g))
    direction = -g
    gnorm = gnorm_prev
    alpha = alg.step0
    for it in range(1, alg.maxiter + 1):
        improved = False
        for _ in range(12):
            psi_new = InfiniteMPS.from_AL(_retract(psi.AL, direction, alpha))
            f_dev, g_new, GLg, GRg = _boundary_value_and_gradient(
                psi_new, Os, 1e-12, GL0=GLg, GR0=GRg)
            f_new = to_host(f_dev)[0]
            if f_new < f + 1e-14:
                improved = True
                break
            alpha *= 0.5
        if not improved:
            break
        psi, f = psi_new, f_new
        gnorm, beta = to_host(torch.linalg.vector_norm(g_new),
                              _cg_beta(g_new, g, gnorm_prev))
        if gnorm < alg.tol:
            break
        direction = -g_new + max(0.0, beta) * _project(psi.AL, direction)
        g, gnorm_prev = g_new, gnorm
        alpha = min(alpha * 2.0, 1.0)
        if alg.verbosity >= VERBOSE_ITER:
            log.conv(it, f, gnorm)
    envs = mpo_environments(psi, Os, GL0=GLg, GR0=GRg)
    return psi, envs, gnorm


def leading_boundary(psi, O, alg=None):
    """Boundary fixed point of a transfer MPO: an InfiniteMPS with a
    DenseMPO or an FSM MPOHamiltonian row (read through its stacked site
    tensors), or an MPSMultiline with an MPOMultiline (rows coupled
    cyclically, row r's transfer mapping row r to row r+1). `alg` is
    VUMPS_Boundary (the default), VOMPS or GradientGrassmann. Returns (psi,
    envs, eps); a multi-row run returns one environment per row."""
    from .grassmann import GradientGrassmann

    if alg is None:
        alg = VUMPS_Boundary()
    with matmul_precision():
        if isinstance(psi, MPSMultiline) or (
                isinstance(O, MPOMultiline) and O.nrows > 1):
            return _leading_boundary_multiline(psi, O, alg)
        if isinstance(O, MPOMultiline):
            O = O.rows[0]
        if not isinstance(psi, InfiniteMPS):
            raise TypeError(f"leading_boundary needs an InfiniteMPS or an "
                            f"MPSMultiline, got {type(psi).__name__}")
        L = psi.period
        if O.period not in (L, 1):
            raise ValueError(f"an MPO of period {O.period} on a cell of {L}")
        Os = stack_O(O, L, psi.dtype, psi.device)
        if isinstance(alg, GradientGrassmann):
            return _leading_boundary_grassmann(psi, Os, alg)

        log = IterLog("leading_boundary", alg.verbosity)
        eps, it = 1.0, 0
        GLg = GRg = None
        for it in range(1, alg.maxiter + 1):
            if isinstance(alg, VOMPS):
                psi, eps_dev, GLg, GRg, env_resid = _boundary_vomps_iteration(
                    psi, Os, alg.gauge_tol, 1e-12, GL_guess=GLg, GR_guess=GRg)
                if env_resid > 1e-6 and alg.verbosity >= 1:
                    logger.warning(
                        "leading_boundary(VOMPS): iteration %d: environment "
                        "fixed-point residual %.4e (Arnoldi not converged)",
                        it, env_resid)
            else:
                inner_tol = updatetol(eps, it)
                # the previous fixed points seed the environment solves
                psi, eps_dev, GLg, GRg, diag = _boundary_vumps_iteration(
                    psi, Os, alg.krylovdim, alg.gauge_tol, 1e-12, inner_tol,
                    GL_guess=GLg, GR_guess=GRg)
                log.solver_warn(it, diag[:2], inner_tol)
                if diag[2] > 1e-6 and alg.verbosity >= 1:
                    logger.warning(
                        "leading_boundary: iteration %d: environment "
                        "fixed-point residual %.4e (Arnoldi not converged)",
                        it, diag[2])
            eps = to_host(eps_dev)[0]
            if alg.verbosity >= VERBOSE_ITER:
                log.conv(it, 0.0, eps)
            if eps < alg.tol:
                break
        else:
            log.cancel(alg.maxiter, 0.0, eps)

        envs = mpo_environments(psi, Os)
        # a (near-)degenerate dominant transfer eigenvalue gives a silently
        # wrong boundary on symmetry-broken / critical problems: warn
        if alg.verbosity >= 1:
            transfer_uniqueness_warning(psi, Os, tol=max(alg.tol, 1e-9),
                                        name="leading_boundary")
    return psi, envs, eps


def _leading_boundary_multiline(psi, O, alg):
    """Multi-row boundary VUMPS: per-row mixed environments (ket row r,
    bra row r+1), then one coupled dominant eigensolve over the stacked
    rows' ACs and one over their Cs, whose matvec applies row r's channel
    and shifts the result to row r+1."""
    if isinstance(psi, InfiniteMPS):
        psi = MPSMultiline.from_mps(psi, O.nrows)
    R, L = psi.nrows, psi.period
    if not (isinstance(O, MPOMultiline) and O.nrows == R):
        raise ValueError("a multi-row boundary needs an MPOMultiline with "
                         "one row per state row")
    dtype, device = psi.rows[0].dtype, psi.rows[0].device
    Os = [stack_O(O.row(r), L, dtype, device) for r in range(R)]

    log = IterLog("leading_boundary_multiline", alg.verbosity)
    eps, it = 1.0, 0
    guesses = [(None, None)] * R
    for it in range(1, alg.maxiter + 1):
        env_tol = max(updatetol(eps, it) * 1e-2, 1e-12)
        envs = [mpo_environments(psi.rows[r], Os[r],
                                 psi_bra=psi.rows[(r + 1) % R], tol=env_tol,
                                 GL0=guesses[r][0], GR0=guesses[r][1])
                for r in range(R)]
        guesses = [(e.GLs[0], e.GRs[L - 1]) for e in envs]

        def mv_ac(x):
            y = torch.stack([torch.stack([
                ac_apply(envs[r].GLs[i], Os[r][i], envs[r].GRs[i], x[r, i])
                for i in range(L)]) for r in range(R)])
            return torch.roll(y, 1, dims=0)

        def mv_c(x):
            y = torch.stack([torch.stack([
                c_apply(envs[r].GLs[(i + 1) % L], envs[r].GRs[i], x[r, i])
                for i in range(L)]) for r in range(R)])
            return torch.roll(y, 1, dims=0)

        inner_tol = updatetol(eps, it)
        resA = dominant_eigs(mv_ac, torch.stack([p.AC for p in psi.rows]),
                             alg.krylovdim, 20, inner_tol)
        resC = dominant_eigs(mv_c, torch.stack([p.C for p in psi.rows]),
                             alg.krylovdim, 20, inner_tol)
        log.solver_warn(it, (int(not resA.converged) + int(not resC.converged),
                             max(resA.residual, resC.residual)), inner_tol)
        env_resid = max(e.resid for e in envs)
        if env_resid > 1e-6 and alg.verbosity >= 1:
            logger.warning(
                "leading_boundary_multiline: iteration %d: environment "
                "fixed-point residual %.4e (Arnoldi not converged)", it,
                env_resid)

        rows, eps_rows = [], []
        for r in range(R):
            ALs, eps_r = _boundary_regauge(_normalized(resA.eigenvector[r]),
                                           _normalized(resC.eigenvector[r]))
            eps_rows.append(eps_r)
            rows.append(InfiniteMPS.from_AL(ALs, tol=alg.gauge_tol))
        psi = MPSMultiline(tuple(rows))
        eps = max(to_host(*eps_rows))
        if alg.verbosity >= VERBOSE_ITER:
            log.conv(it, 0.0, eps)
        if eps < alg.tol:
            break
    else:
        log.cancel(alg.maxiter, 0.0, eps)

    envs = [mpo_environments(psi.rows[r], Os[r],
                             psi_bra=psi.rows[(r + 1) % R])
            for r in range(R)]
    return psi, envs, eps
