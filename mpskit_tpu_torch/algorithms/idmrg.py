"""Infinite DMRG (counterpart of mpskit_tpu/algorithms/idmrg.py).

IDMRG1 sweeps left and right through the unit cell and grows the
environments by one cell per iteration instead of solving for them; the
identity FSM level is re-regularized on every push, so the accumulated
energy never enters the effective Hamiltonians. IDMRG2 is the two-site
variant with truncated-SVD re-splitting, periodic wrap included.

The JAX package runs an iteration as one jit-compiled function of two
`lax.scan`s whose outputs `jnp.roll` re-seats; here the scans are host
loops that write each output to its seat directly. Per-bond quantities
stay on the device; the drivers read the convergence measure once per
iteration.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import Defaults, VERBOSE_ITER, matmul_precision
from ..environments.finite import stack_W
from ..environments.infinite_ham import hamiltonian_environments, pairing
from ..linalg.lanczos import eigsh_smallest
from ..states.infinitemps import InfiniteMPS
from ..tensors.ops import (
    TruncationScheme, leftorth, notrunc, rightorth, svd_truncated,
)
from ..transfermatrix.transfer import transfer_left_mpo, transfer_right_mpo
from ..utils.dynamictols import updatetol
from ..utils.logging import IterLog
from ..utils.sync import to_host
from .derivatives import ac2_apply, ac_apply
from .unionalg import Chainable


@dataclasses.dataclass(frozen=True)
class IDMRG1(Chainable):
    tol: float = 1e-9
    maxiter: int = Defaults.maxiter
    krylovdim: int = Defaults.krylovdim
    eig_maxrestarts: int = 4
    verbosity: int = Defaults.verbosity


@dataclasses.dataclass(frozen=True)
class IDMRG2(Chainable):
    tol: float = 1e-9
    maxiter: int = Defaults.maxiter
    krylovdim: int = Defaults.krylovdim
    eig_maxrestarts: int = 4
    trscheme: TruncationScheme = dataclasses.field(default_factory=notrunc)
    verbosity: int = Defaults.verbosity


def _reg_left(GL, C):
    """Subtract the identity component of the top FSM level (the energy
    drift)."""
    w, D = GL.shape[0], GL.shape[1]
    coeff = pairing(GL[w - 1], torch.einsum("mk,nk->mn", C.conj(), C))
    GL = GL.clone()
    GL[w - 1] -= coeff * torch.eye(D, dtype=GL.dtype, device=GL.device)
    return GL


def _reg_right(GR, C):
    D = GR.shape[1]
    coeff = pairing(GR[0], torch.einsum("km,kn->mn", C.conj(), C))
    GR = GR.clone()
    GR[0] -= coeff * torch.eye(D, dtype=GR.dtype, device=GR.device)
    return GR


def _idmrg1_iteration(ALs, ARs, AC0, Cs, GLs, GRs, m: int, restarts: int,
                      Ws=None, inner_tol=1e-6):
    """One IDMRG1 iteration: left to right, then right to left through the
    cell. Returns (ALs, ARs, AC, Cs, GLs, GRs, lam, err, diag): lam the
    eigenvalue of site 0 (host float), err = |C_new - C_old| at the cell's
    last bond (0-dim tensor), diag on the host. The inputs are not
    modified."""
    L = ALs.shape[0]
    lams, resids, convs = [], [], []

    def solve(GL, W, GR, AC):
        res = eigsh_smallest(lambda x: ac_apply(GL, W, GR, x), AC, m,
                             restarts, inner_tol)
        lams.append(res.eigenvalue)
        resids.append(res.residual)
        convs.append(res.converged)
        return res.eigenvector

    # ---- left to right: GLs_new[(i+1) % L] = env right of site i ----
    ALs_n = torch.empty_like(ALs)
    GLs_n = torch.empty_like(GLs)
    AC, GL = AC0, GLs[0]
    for i in range(L):
        AL, C = leftorth(solve(GL, Ws[i], GRs[i], AC))
        GL = _reg_left(transfer_left_mpo(GL, Ws[i], AL, AL), C)
        AC = torch.einsum("lm,mpr->lpr", C, ARs[(i + 1) % L])
        ALs_n[i] = AL
        GLs_n[(i + 1) % L] = GL

    # ---- right to left: GRs_new[(i-1) % L] = env left of site i, and
    # Cs_new[(i-1) % L] = C on the bond left of site i ----
    lams.clear()
    ARs_n = torch.empty_like(ARs)
    GRs_n = torch.empty_like(GRs)
    Cs_n = torch.empty_like(Cs)
    GR = GRs[L - 1]
    for i in range(L - 1, -1, -1):
        C, AR = rightorth(solve(GLs_n[i], Ws[i], GR, AC))
        GR = _reg_right(transfer_right_mpo(GR, Ws[i], AR, AR), C)
        AC = torch.einsum("lpm,mr->lpr", ALs_n[(i - 1) % L], C)
        ARs_n[i] = AR
        GRs_n[(i - 1) % L] = GR
        Cs_n[(i - 1) % L] = C

    err = torch.linalg.vector_norm(Cs_n[L - 1] - Cs[L - 1])
    return (ALs_n, ARs_n, AC, Cs_n, GLs_n, GRs_n, lams[-1], err,
            (sum(not c for c in convs), max(resids)))


def find_groundstate_idmrg1(psi: InfiniteMPS, H, alg: IDMRG1 = IDMRG1()):
    """Run IDMRG1. Returns (psi, envs, err)."""
    L = psi.period
    log = IterLog("IDMRG1", alg.verbosity)
    err = 1.0
    it = 0
    with matmul_precision():
        envs = hamiltonian_environments(psi, H)
        Ws = stack_W(H, L, psi.dtype, psi.device)
        ALs, ARs, Cs, AC0 = psi.AL, psi.AR, psi.C, psi.AC[0]
        GLs, GRs = envs.GLs, envs.GRs
        for it in range(1, alg.maxiter + 1):
            inner_tol = updatetol(err, it)
            ALs, ARs, AC0, Cs, GLs, GRs, lam, err_dev, diag = \
                _idmrg1_iteration(ALs, ARs, AC0, Cs, GLs, GRs,
                                  alg.krylovdim, alg.eig_maxrestarts,
                                  Ws=Ws, inner_tol=inner_tol)
            err = to_host(err_dev)[0]
            log.solver_warn(it, diag, inner_tol)
            if alg.verbosity >= VERBOSE_ITER:
                log.conv(it, lam, err)
            if err < alg.tol:
                break
        else:
            log.cancel(it, 0.0, err)
        # re-gauge into a clean uniform MPS
        psi = InfiniteMPS.from_A(ARs)
        envs = hamiltonian_environments(psi, H)
    return psi, envs, err


def _split2(theta, trscheme: TruncationScheme):
    D, d = theta.shape[0], theta.shape[1]
    U, S, Vh, err = svd_truncated(theta.reshape(D * d, d * D), D, trscheme)
    S = S / torch.clamp(torch.linalg.vector_norm(S), min=1e-30)
    return U.reshape(D, d, D), S, Vh.reshape(D, d, D), err


def _idmrg2_iteration(ALs, ARs, AC0, Ss_prev, GLs, GRs, m: int,
                      restarts: int, trscheme: TruncationScheme, Ws=None,
                      inner_tol=1e-6):
    """One IDMRG2 iteration: left to right, then right to left over all L
    bonds of the cell (bond i joins sites i and (i+1) % L; the wrap is
    covered by carrying AC through the loops). Needs L >= 2. Returns
    (ALs, ARs, AC, Ss, GLs, GRs, lam, dC, err_trunc, diag): Ss[i] the
    Schmidt values of bond i, dC = |S_new - S_old| at the last bond and
    err_trunc the largest discarded weight (0-dim tensors), lam the
    eigenvalue of bond 0 (host float)."""
    L = ALs.shape[0]
    lams, resids, convs = [], [], []
    errs = []

    def solve(GL, W1, W2, GR, theta):
        res = eigsh_smallest(lambda x: ac2_apply(GL, W1, W2, GR, x), theta,
                             m, restarts, inner_tol)
        lams.append(res.eigenvalue)
        resids.append(res.residual)
        convs.append(res.converged)
        return res.eigenvector

    # ---- left to right over bonds i = 0..L-1; AC at site i, GL left of
    # it; GLs_new[(i+1) % L] = env left of site i+1 ----
    ALs_n = torch.empty_like(ALs)
    GLs_n = torch.empty_like(GLs)
    AC, GL = AC0, GLs[0]
    for i in range(L):
        j = (i + 1) % L
        theta = torch.einsum("lpm,mqr->lpqr", AC, ARs[j])
        AL, S, AR, err = _split2(solve(GL, Ws[i], Ws[j], GRs[j], theta),
                                 trscheme)
        errs.append(err)
        GL = _reg_left(transfer_left_mpo(GL, Ws[i], AL, AL),
                       torch.diag(S.to(AL.dtype)))
        AC = S.to(AR.dtype)[:, None, None] * AR
        ALs_n[i] = AL
        GLs_n[j] = GL

    # ---- right to left over bonds i = L-1..0; AC at site i+1, GR right
    # of it. The first bond, L-1, takes the AC at site 0 that the first
    # loop carried and the old GR right of site 0 ----
    lams.clear()
    ARs_n = torch.empty_like(ARs)
    GRs_n = torch.empty_like(GRs)
    Ss_n = torch.empty_like(Ss_prev)
    GR = GRs[0]
    for i in range(L - 1, -1, -1):
        j = (i + 1) % L
        theta = torch.einsum("lpm,mqr->lpqr", ALs_n[i], AC)
        AL, S, AR, err = _split2(solve(GLs_n[i], Ws[i], Ws[j], GR, theta),
                                 trscheme)
        errs.append(err)
        GR = _reg_right(transfer_right_mpo(GR, Ws[j], AR, AR),
                        torch.diag(S.to(AR.dtype)))
        AC = AL * S.to(AL.dtype)[None, None, :]
        ARs_n[j] = AR
        GRs_n[i] = GR
        Ss_n[i] = S

    err_trunc = torch.stack(errs).max()
    dC = torch.linalg.vector_norm(Ss_n[L - 1] - Ss_prev[L - 1])
    return (ALs_n, ARs_n, AC, Ss_n, GLs_n, GRs_n, lams[-1], dC, err_trunc,
            (sum(not c for c in convs), max(resids)))


def find_groundstate_idmrg2(psi: InfiniteMPS, H, alg: IDMRG2 = IDMRG2()):
    """Run IDMRG2 (unit cell of at least 2 sites). Returns (psi, envs,
    err)."""
    L = psi.period
    if L < 2:
        raise ValueError("IDMRG2 needs a unit cell of at least 2 sites")
    log = IterLog("IDMRG2", alg.verbosity)
    err = 1.0
    it = 0
    with matmul_precision():
        envs = hamiltonian_environments(psi, H)
        Ws = stack_W(H, L, psi.dtype, psi.device)
        ALs, ARs, AC0 = psi.AL, psi.AR, psi.AC[0]
        Ss = torch.linalg.svdvals(psi.C)
        GLs, GRs = envs.GLs, envs.GRs
        for it in range(1, alg.maxiter + 1):
            inner_tol = updatetol(err, it)
            (ALs, ARs, AC0, Ss, GLs, GRs, lam, dC, _,
             diag) = _idmrg2_iteration(
                ALs, ARs, AC0, Ss, GLs, GRs, alg.krylovdim,
                alg.eig_maxrestarts, alg.trscheme, Ws=Ws,
                inner_tol=inner_tol)
            err = to_host(dC)[0]
            log.solver_warn(it, diag, inner_tol)
            if alg.verbosity >= VERBOSE_ITER:
                log.conv(it, lam, err)
            if err < alg.tol:
                break
        else:
            log.cancel(it, 0.0, err)
        psi = InfiniteMPS.from_A(ARs)
        envs = hamiltonian_environments(psi, H)
    return psi, envs, err
