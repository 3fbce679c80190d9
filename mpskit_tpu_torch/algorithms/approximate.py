"""Variational approximation psi ~= O . phi (counterpart of
mpskit_tpu/algorithms/approximate.py): one- and two-site fitting sweeps for
finite states, VOMPS-style power updates and IDMRG1/2-style pushed
environments for infinite states, the multi-row route, and plain state
compression (O = None).

The JAX package scans the sweeps and the IDMRG cycles; here they are host
loops over the sites that write each output to its seat. FitDMRG2's split
is the port's `svd_truncated`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Defaults, matmul_precision
from ..environments.finite import stack_W
from ..environments.infinite_mpo import mpo_environments
from ..operators.mpo import DenseMPO, MPOHamiltonian
from ..operators.multiline import MPOMultiline
from ..states.finitemps import FiniteMPS
from ..states.infinitemps import InfiniteMPS
from ..states.multiline import MPSMultiline
from ..states.quasiparticle import full_gauges
from ..tensors.ops import leftorth, notrunc, rightorth, svd_truncated
from ..transfermatrix.transfer import transfer_left_mpo, transfer_right_mpo
from ..utils.logging import IterLog, logger
from ..utils.sync import to_host
from .derivatives import ac2_apply, ac_apply, c_apply
from .statmech import _boundary_regauge, _normalized


@dataclasses.dataclass(frozen=True)
class FitDMRG:
    """One-site fitting sweeps."""

    tol: float = 1e-10
    maxiter: int = 60
    verbosity: int = Defaults.verbosity


@dataclasses.dataclass(frozen=True)
class FitDMRG2:
    """Two-site fitting sweeps with an SVD re-split at the state's bond
    dimension, which adapts psi's Schmidt content while fitting."""

    tol: float = 1e-10
    maxiter: int = 60
    trscheme: object = None
    verbosity: int = Defaults.verbosity


@dataclasses.dataclass(frozen=True)
class FitIDMRG:
    """IDMRG1-style fitting of infinite states: the environments are pushed
    (and normalized) around the unit cell instead of re-solved; every site
    update is one projection."""

    tol: float = 1e-10
    maxiter: int = 100
    verbosity: int = Defaults.verbosity


@dataclasses.dataclass(frozen=True)
class FitIDMRG2:
    """IDMRG2-style two-site fitting of infinite states, re-split by SVD at
    the state's bond dimension; needs a unit cell of >= 2 sites."""

    tol: float = 1e-10
    maxiter: int = 100
    verbosity: int = Defaults.verbosity


def _identity_mpo(d: int, L: int) -> DenseMPO:
    return DenseMPO(tuple([np.eye(d)[None, None]] * L))


def _as_stack(O, L: int, dtype, device):
    """(L, w, w, d, d) device tensor of an MPOHamiltonian (its FSM) or a
    DenseMPO (ragged size-1 edge bonds zero-padded to one width, valid
    entries leading), cast to dtype (a real dtype keeps the real part)."""
    if isinstance(O, MPOHamiltonian):
        return stack_W(O, L, dtype, device)
    arr = DenseMPO(tuple(O.site(i) for i in range(L))).stacked_uniform()
    if not dtype.is_complex and np.iscomplexobj(arr):
        arr = arr.real
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device,
                                                          dtype=dtype)


def _unit(x):
    return x / torch.clamp(torch.linalg.vector_norm(x), min=1e-30)


def _split2(theta, D: int, d: int):
    """theta (D, d, d, D) -> (AL, S normalized, AR) at width D."""
    U, S, Vh, _ = svd_truncated(theta.reshape(D * d, d * D), D, notrunc())
    S = S / torch.clamp(torch.linalg.vector_norm(S), min=1e-30)
    return U.reshape(D, d, D), S, Vh.reshape(D, d, D)


def _fit_sweep(Os, phiA, GRs, GL0, GRL):
    """One left-to-right and right-to-left one-site fitting sweep, AC_i <-
    GL_mix W GR_mix AC^phi_i (the mixed environments have phi as ket and
    psi as bra). Returns (ALs, ARs, AC at site 0, the new right
    environments)."""
    phiAL, phiAR, phiAC = phiA
    L = Os.shape[0]
    ALs, ARs = torch.empty_like(phiAL), torch.empty_like(phiAR)
    GLs = torch.empty((L + 1,) + tuple(GL0.shape), dtype=GL0.dtype,
                      device=GL0.device)
    GL = GL0
    for i in range(L):
        AL, _ = leftorth(_unit(ac_apply(GL, Os[i], GRs[i + 1], phiAC[i])))
        ALs[i], GLs[i] = AL, GL
        GL = transfer_left_mpo(GL, Os[i], phiAL[i], AL)
    GLs[L] = GL
    GRs_new = torch.empty_like(GLs)
    GR = GRL
    for i in range(L - 1, -1, -1):
        AC = _unit(ac_apply(GLs[i], Os[i], GR, phiAC[i]))
        _, ARs[i] = rightorth(AC)
        GRs_new[i + 1] = GR
        GR = transfer_right_mpo(GR, Os[i], phiAR[i], ARs[i])
    GRs_new[0] = GR
    return ALs, ARs, AC, GRs_new


def _fit2_sweep(ALs, ARs, Os, phiA, GRs, GL0, GRL):
    """Two-site fitting sweep: theta_i <- GL_mix W_i W_{i+1} GR_mix
    theta^phi, re-split by SVD. Returns (ALs, ARs, AC at site 0)."""
    phiAL, phiAR, phiAC = phiA
    L, D, d = ALs.shape[0], ALs.shape[1], ALs.shape[2]
    ALs, ARs = ALs.clone(), ARs.clone()
    GLs = [None] * L
    GL = GL0
    for i in range(L - 1):
        theta_phi = torch.einsum("lpm,mqr->lpqr", phiAC[i], phiAR[i + 1])
        theta = _unit(ac2_apply(GL, Os[i], Os[i + 1], GRs[i + 2], theta_phi))
        ALs[i] = _split2(theta, D, d)[0]
        GLs[i] = GL
        GL = transfer_left_mpo(GL, Os[i], phiAL[i], ALs[i])
    GR, AC = GRL, None
    for i in range(L - 2, -1, -1):
        theta_phi = torch.einsum("lpm,mqr->lpqr", phiAL[i], phiAC[i + 1])
        theta = _unit(ac2_apply(GLs[i], Os[i], Os[i + 1], GR, theta_phi))
        AL, S, ARs[i + 1] = _split2(theta, D, d)
        GR = transfer_right_mpo(GR, Os[i + 1], phiAR[i + 1], ARs[i + 1])
        AC = torch.einsum("lpm,m->lpm", AL, S.to(AL.dtype))
    return ALs, ARs, AC


def _mixed_right_envs_fit(phiAR, ARs, Os, GRL):
    """Right mixed environments (ket the target phi, bra the current psi),
    (L+1, w, D, D): entry i+1 is the one right of site i."""
    L = Os.shape[0]
    GRs = torch.empty((L + 1,) + tuple(GRL.shape), dtype=GRL.dtype,
                      device=GRL.device)
    GR = GRL
    for i in range(L - 1, -1, -1):
        GRs[i + 1] = GR
        GR = transfer_right_mpo(GR, Os[i], phiAR[i], ARs[i])
    GRs[0] = GR
    return GRs


def approximate(psi, target, alg=None, envs=None):
    """approximate(psi, (O, phi)[, alg]) or approximate(psi, phi[, alg]):
    fit psi, at its own bond dimension, to O . phi. FiniteMPS: FitDMRG
    (default) or FitDMRG2 sweeps; InfiniteMPS: FitIDMRG / FitIDMRG2, or
    VOMPS-style power updates for any other alg; MPSMultiline: row r of
    psi fits O's row r-1 applied to phi's row r-1. `envs` is accepted for
    signature parity. Returns (psi, envs, epsilon)."""
    if alg is None:
        alg = FitDMRG()
    O, phi = target if isinstance(target, tuple) else (None, target)
    with matmul_precision():
        if isinstance(psi, FiniteMPS):
            return _approximate_finite(psi, O, phi, alg)
        if isinstance(psi, MPSMultiline) or isinstance(phi, MPSMultiline):
            return _approximate_multiline(psi, O, phi, alg)
        if isinstance(psi, InfiniteMPS):
            if isinstance(alg, (FitIDMRG, FitIDMRG2)):
                return _approximate_idmrg(psi, O, phi, alg)
            return _approximate_infinite(psi, O, phi, alg)
    raise TypeError(type(psi))


def _approximate_multiline(psi, O, phi, alg):
    """Row r of the MPO maps phi's row r onto psi's row r+1, so each output
    row is an independent single-row fit. Returns (MPSMultiline, per-row
    envs, the largest per-row eps)."""
    if isinstance(psi, InfiniteMPS):
        psi = MPSMultiline.from_mps(
            psi, phi.nrows if isinstance(phi, MPSMultiline) else 1)
    if isinstance(phi, InfiniteMPS):
        phi = MPSMultiline.from_mps(phi, psi.nrows)
    R = psi.nrows
    if phi.nrows != R:
        raise ValueError(f"phi has {phi.nrows} rows, psi {R}")
    if not isinstance(O, MPOMultiline):
        O = MPOMultiline.from_mpo(
            O if O is not None
            else _identity_mpo(phi.rows[0].physicaldim, phi.period), R)
    if O.nrows not in (1, R):
        raise ValueError(f"an MPOMultiline of {O.nrows} rows on {R}")
    fit = (_approximate_idmrg if isinstance(alg, (FitIDMRG, FitIDMRG2))
           else _approximate_infinite)
    rows, envs_rows, eps = list(psi.rows), [None] * R, 0.0
    for r in range(R):
        out, env, err = fit(psi.rows[(r + 1) % R], O.row(r), phi.rows[r],
                            alg)
        rows[(r + 1) % R], envs_rows[(r + 1) % R] = out, env
        eps = max(eps, float(err))
    return MPSMultiline(tuple(rows)), envs_rows, eps


def _approximate_finite(psi: FiniteMPS, O, phi: FiniteMPS, alg):
    L, D, d = psi.length, psi.D, psi.physicaldim
    dtype, device = psi.dtype, psi.device
    Os = _as_stack(_identity_mpo(d, L) if O is None else O, L, dtype, device)
    w = Os.shape[1]
    ALs_phi, ARs_phi = full_gauges(phi)
    phiA = (ALs_phi, ARs_phi,
            torch.stack([phi.move_center(i).AC for i in range(L)]))
    psi0 = psi.move_center(0)
    ALs, ARs, AC = psi0.ALs, psi0.ARs, psi0.AC
    # the right boundary selects the final FSM level of a Hamiltonian and
    # level 0 of an evolution / identity / transfer MPO
    GRL = torch.zeros((w, D, D), dtype=dtype, device=device)
    GRL[w - 1 if isinstance(O, MPOHamiltonian) else 0, 0, 0] = 1.0
    GL0 = torch.zeros((w, D, D), dtype=dtype, device=device)
    GL0[0, 0, 0] = 1.0

    GRs = _mixed_right_envs_fit(phiA[1], ARs, Os, GRL)
    prev, eps = None, 1.0
    for _ in range(alg.maxiter):
        if isinstance(alg, FitDMRG2):
            ALs, ARs, AC = _fit2_sweep(ALs, ARs, Os, phiA, GRs, GL0, GRL)
            GRs = _mixed_right_envs_fit(phiA[1], ARs, Os, GRL)
        else:
            ALs, ARs, AC, GRs = _fit_sweep(Os, phiA, GRs, GL0, GRL)
        if prev is not None:
            eps = to_host(torch.linalg.vector_norm(AC - prev))[0]
        prev = AC
        if eps < alg.tol:
            break
    return FiniteMPS(ALs, ARs, AC, 0), None, eps


def _fit_idmrg1_iteration(Cs, GLs, GRs, Os, phiAL, phiAR, phiAC):
    """One IDMRG1 fitting iteration: a left-to-right and a right-to-left
    single-site projection cycle around the cell with normalized
    environment pushes. Returns (ALs, ARs, Cs, GLs, GRs, err), err (a
    0-dim tensor) the phase-aligned change of the boundary bond's C."""
    L = Os.shape[0]
    ALs, ARs = torch.empty_like(phiAL), torch.empty_like(phiAR)
    GLs, GRs, Cs_new = GLs.clone(), GRs.clone(), torch.empty_like(Cs)
    GL = GLs[0]
    for i in range(L):
        ALs[i], _ = leftorth(_unit(ac_apply(GL, Os[i], GRs[i], phiAC[i])))
        GL = _unit(transfer_left_mpo(GL, Os[i], phiAL[i], ALs[i]))
        GLs[(i + 1) % L] = GL
    GR = GRs[L - 1]
    for i in range(L - 1, -1, -1):
        C, ARs[i] = rightorth(_unit(ac_apply(GLs[i], Os[i], GR,
                                             phiAC[i])))
        # C sits at the bond left of site i
        Cs_new[(i - 1) % L] = C
        GR = _unit(transfer_right_mpo(GR, Os[i], phiAR[i], ARs[i]))
        GRs[(i - 1) % L] = GR
    C_old = Cs[L - 1]
    ph = torch.vdot(C_old.reshape(-1), Cs_new[L - 1].reshape(-1))
    ph = ph / torch.clamp(ph.abs(), min=1e-30)
    err = torch.linalg.vector_norm(Cs_new[L - 1] - ph * C_old)
    return ALs, ARs, Cs_new, GLs, GRs, err


def _fit_idmrg2_iteration(Cs, GLs, GRs, Os, phiAL, phiAR, phiAC):
    """One IDMRG2 fitting iteration: two-site projections theta <- GL W W
    GR theta^phi re-split by SVD at the state's width, bonds (i, i+1 mod
    L) left to right, then right to left with the wrap. err is the change
    of the boundary bond's sorted singular values."""
    L, D, d = phiAC.shape[0], phiAC.shape[1], phiAC.shape[2]
    ALs, ARs = torch.zeros_like(phiAC), torch.zeros_like(phiAC)
    Cs_new = torch.zeros_like(Cs)
    GLs, GRs = GLs.clone(), GRs.clone()

    def bond(ii, jj, theta_phi):
        theta = _unit(ac2_apply(GLs[ii], Os[ii], Os[jj], GRs[jj], theta_phi))
        AL, S, AR = _split2(theta, D, d)
        ALs[ii], ARs[jj] = AL, AR
        Cs_new[ii] = torch.diag(S.to(theta.dtype))
        GL = _unit(transfer_left_mpo(GLs[ii], Os[ii], phiAL[ii], AL))
        GR = _unit(transfer_right_mpo(GRs[jj], Os[jj], phiAR[jj], AR))
        GLs[jj], GRs[ii] = GL, GR

    for i in range(L):
        j = (i + 1) % L
        bond(i, j, torch.einsum("lpm,mqr->lpqr", phiAC[i], phiAR[j]))
    for i in range(L - 2, L - 2 - L, -1):
        ii, jj = i % L, (i + 1) % L
        bond(ii, jj, torch.einsum("lpm,mqr->lpqr", phiAL[ii], phiAC[jj]))
    s_new = torch.sort(torch.diagonal(Cs_new[L - 1]).abs(),
                       descending=True)[0]
    s_old = torch.sort(torch.diagonal(Cs[L - 1]).abs(), descending=True)[0]
    return ALs, ARs, Cs_new, GLs, GRs, torch.linalg.vector_norm(s_new - s_old)


def _approximate_idmrg(psi: InfiniteMPS, O, phi: InfiniteMPS, alg):
    """Mixed fixed-point environments once, then cheap pushed-environment
    iterations; the result is re-gauged from the AL family."""
    L, dtype, device = psi.period, psi.dtype, psi.device
    name = "FitIDMRG2" if isinstance(alg, FitIDMRG2) else "FitIDMRG"
    if isinstance(alg, FitIDMRG2) and L < 2:
        raise ValueError("FitIDMRG2 needs a unit cell of >= 2 sites")
    Os = _as_stack(_identity_mpo(psi.physicaldim, L) if O is None else O, L,
                   dtype, device)
    envs = mpo_environments(phi, Os, psi_bra=psi)
    if alg.verbosity >= 1 and envs.resid > 1e-6:
        logger.warning("%s: mixed environment fixed-point residual %.4e "
                       "(Arnoldi not converged)", name, envs.resid)
    GLs, GRs = _normalized(envs.GLs), _normalized(envs.GRs)
    ALs, Cs = psi.AL, psi.C
    log = IterLog(name, alg.verbosity)
    err, it = 1.0, 0
    for it in range(1, alg.maxiter + 1):
        step = (_fit_idmrg2_iteration if isinstance(alg, FitIDMRG2)
                else _fit_idmrg1_iteration)
        ALs, _, Cs, GLs, GRs, err_dev = step(Cs, GLs, GRs, Os, phi.AL,
                                             phi.AR, phi.AC)
        err = to_host(err_dev)[0]
        if err < alg.tol:
            break
    else:
        log.cancel(it, 0.0, err)
    out = InfiniteMPS.from_AL(ALs, Cs[L - 1])
    return out, mpo_environments(phi, Os, psi_bra=out), err


def _approximate_infinite(psi: InfiniteMPS, O, phi: InfiniteMPS, alg):
    """VOMPS-style fitting: one mixed-environment power update per
    iteration."""
    L, dtype, device = psi.period, psi.dtype, psi.device
    Os = _as_stack(_identity_mpo(psi.physicaldim, L) if O is None else O, L,
                   dtype, device)
    eps, envs = 1.0, None
    for it in range(1, alg.maxiter + 1):
        envs = mpo_environments(phi, Os, psi_bra=psi)
        if alg.verbosity >= 1 and envs.resid > 1e-6:
            logger.warning(
                "approximate(VOMPS): iteration %d: mixed environment "
                "fixed-point residual %.4e (Arnoldi not converged)", it,
                envs.resid)
        ACs = torch.stack([ac_apply(envs.GLs[i], Os[i], envs.GRs[i],
                                    phi.AC[i]) for i in range(L)])
        Cs = torch.stack([c_apply(envs.GLs[(i + 1) % L], envs.GRs[i],
                                  phi.C[i]) for i in range(L)])
        ALs, eps_dev = _boundary_regauge(_normalized(ACs), _normalized(Cs))
        eps = to_host(eps_dev)[0]
        psi = InfiniteMPS.from_AL(ALs, psi.C[L - 1])
        if eps < alg.tol:
            break
    return psi, envs, eps
