"""Two-site DMRG (counterpart of mpskit_tpu/algorithms/dmrg2.py).

Each bond's two-site tensor is solved with `eigsh_smallest` on
`ac2_apply` and split again by `svd_truncated`; the truncation is masked,
so every tensor keeps the static bond dimension D. The JAX package runs a
sweep as one jit-compiled function of two `lax.scan`s; here the scans are
host loops over the bonds, and the tensor and environment stacks are
updated in place where the JAX package donates its buffers. The per-bond
discarded weights stay on the device and are read once per sweep.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import Defaults, VERBOSE_ITER, matmul_precision
from ..environments.finite import (
    FiniteEnv, compute_left_envs, compute_right_envs, left_boundary,
    right_boundary, stack_W,
)
from ..linalg.lanczos import eigsh_smallest
from ..states.finitemps import FiniteMPS, physical_bond_dims
from ..tensors.ops import TruncationScheme, notrunc, svd_truncated
from ..transfermatrix.transfer import transfer_left_mpo, transfer_right_mpo
from ..utils.dynamictols import updatetol
from ..utils.logging import IterLog
from ..utils.sync import to_host
from ..utils.trace import span
from .derivatives import ac2_apply
from .unionalg import Chainable


@dataclasses.dataclass(frozen=True)
class DMRG2(Chainable):
    """Two-site DMRG parameters (same fields and defaults as
    mpskit_tpu.algorithms.dmrg2.DMRG2)."""

    tol: float = 1e-10
    maxiter: int = Defaults.maxiter
    krylovdim: int = Defaults.krylovdim
    eig_maxrestarts: int = 10
    trscheme: TruncationScheme = dataclasses.field(default_factory=notrunc)
    verbosity: int = Defaults.verbosity
    finalize: Optional[Callable] = None


def bond_support_vectors(L: int, d: int, D: int) -> np.ndarray:
    """(L+1, D) boolean vectors: entry k of bond i is within the maximal
    physical rank min(d^i, d^(L-i), D). The two-site support mask is an
    outer product of these (theta at bond (i, i+1) lives on rows sup[i] and
    columns sup[i+2])."""
    dims = physical_bond_dims(L, d, D)
    return np.arange(D)[None, :] < dims[:, None]


def _split2(theta, rowm, midm, colm, trscheme: TruncationScheme):
    """Re-split a solved two-site tensor (D, d, d, D) into AL (D, d, D), the
    normalized Schmidt values S (D,) and AR (D, d, D), with the discarded
    weight err (0-dim). The support masks are applied before and after the
    SVD: the padded theta at the chain's edges is exactly rank-deficient,
    and in float32 the solver and the SVD would otherwise leak weight into
    the padding."""
    D, d = theta.shape[0], theta.shape[1]
    theta = theta * rowm[:, None, None, None] * colm[None, None, None, :]
    theta = theta / torch.clamp(torch.linalg.vector_norm(theta), min=1e-30)
    U, S, Vh, err = svd_truncated(theta.reshape(D * d, d * D), D, trscheme)
    S = S * midm
    S = S / torch.clamp(torch.linalg.vector_norm(S), min=1e-30)
    AL = U.reshape(D, d, D) * rowm[:, None, None] * midm[None, None, :]
    AR = Vh.reshape(D, d, D) * midm[:, None, None] * colm[None, None, :]
    return AL, S, AR, err


def _dmrg2_sweep_impl(ALs, ARs, AC, Ws, GRs, inner_tol: float, m: int,
                      restarts: int, trscheme: TruncationScheme,
                      GL0=None, GRL=None, sup=None):
    """One full two-site sweep (bonds 0..L-2 left to right, then back),
    starting and ending with center = 0.

    ALs, ARs and GRs are updated IN PLACE and returned, with the new center
    tensor, the eigenvalue of bond 0 (the last solved), the largest
    discarded weight of the sweep (a host float) and the solver diagnostics
    (n_unconverged, worst_residual). GL0/GRL override the open-chain
    boundary environments; `sup` is the (L+1, D) bond support of
    `bond_support_vectors`."""
    with span("sweep"):
        L, D = ALs.shape[0], ALs.shape[1]
        w = Ws.shape[1]
        dtype, device = AC.dtype, AC.device
        rdtype = AC.real.dtype if AC.is_complex() else dtype
        if GL0 is None:
            GL0 = left_boundary(w, D, dtype, device)
        if GRL is None:
            GRL = right_boundary(w, D, dtype, device)
        if sup is None:
            supf = torch.ones((L + 1, 1), dtype=rdtype, device=device)
        else:
            supf = sup.to(device=device, dtype=rdtype)

        errs = []  # per-bond discarded weights, read once at the end
        lams, resids, convs = [], [], []

        def solve(GL, W1, W2, GR, theta):
            res = eigsh_smallest(lambda x: ac2_apply(GL, W1, W2, GR, x), theta,
                                 m, restarts, inner_tol)
            lams.append(res.eigenvalue)
            resids.append(res.residual)
            convs.append(res.converged)
            return res.eigenvector

        # ---- left to right over bonds (i, i+1), i = 0..L-2 ----
        GLs = torch.empty((L,) + tuple(GL0.shape), dtype=dtype, device=device)
        GL = GL0
        for i in range(L - 1):
            GLs[i] = GL
            W1, W2 = Ws[i], Ws[i + 1]
            theta = torch.einsum("lpm,mqr->lpqr", AC, ARs[i + 1])
            theta = solve(GL, W1, W2, GRs[i + 2], theta)
            AL, S, AR, err = _split2(theta, supf[i], supf[i + 1], supf[i + 2],
                                     trscheme)
            errs.append(err)
            GL = transfer_left_mpo(GL, W1, AL, AL)
            AC = S[:, None, None] * AR
            ALs[i] = AL
        GLs[L - 1] = GL

        # ---- right to left over bonds (i, i+1), i = L-2..0 ----
        GR = GRL
        for i in range(L - 2, -1, -1):
            GRs[i + 2] = GR
            W1, W2 = Ws[i], Ws[i + 1]
            theta = torch.einsum("lpm,mqr->lpqr", ALs[i], AC)
            theta = solve(GLs[i], W1, W2, GR, theta)
            AL, S, AR, err = _split2(theta, supf[i], supf[i + 1], supf[i + 2],
                                     trscheme)
            errs.append(err)
            GR = transfer_right_mpo(GR, W2, AR, AR)
            AC = AL * S[None, None, :]
            ARs[i + 1] = AR
        # GRs[1] is the final carry; GRs[0] is unused and holds the same (as in
        # the JAX package)
        GRs[1] = GR
        GRs[0] = GR

        diag = (sum(not c for c in convs), max(resids))
        return ALs, ARs, AC, GRs, lams[-1], max(to_host(*errs)), diag


def find_groundstate_dmrg2(psi: FiniteMPS, H, alg: DMRG2 = DMRG2()):
    """Run two-site DMRG. Returns (psi, envs, epsilon), epsilon the change
    of the energy over the last sweep."""
    L, D, d = psi.length, psi.D, psi.physicaldim
    dtype, device = psi.dtype, psi.device
    psi = psi.move_center(0)
    Ws = stack_W(H, L, dtype, device)
    w = Ws.shape[1]
    sup = torch.as_tensor(bond_support_vectors(L, d, D), device=device)

    log = IterLog("DMRG2", alg.verbosity)
    # copies: the sweep updates its tensor arguments in place; the caller's
    # psi (and any state a finalize hook returns) must stay valid
    ALs, ARs, AC = psi.ALs.clone(), psi.ARs.clone(), psi.AC.clone()
    eps = 1.0
    lam_prev = None
    lam = 0.0
    it = 0
    with matmul_precision():
        GRs = compute_right_envs(ARs, Ws, right_boundary(w, D, dtype, device))
        for it in range(1, alg.maxiter + 1):
            inner_tol = updatetol(eps, it)
            ALs, ARs, AC, GRs, lam, _, diag = _dmrg2_sweep_impl(
                ALs, ARs, AC, Ws, GRs, inner_tol, alg.krylovdim,
                alg.eig_maxrestarts, alg.trscheme, sup=sup)
            psi = FiniteMPS(ALs, ARs, AC, 0)
            if alg.finalize is not None:
                psi = alg.finalize(it, psi, H) or psi
                ALs, ARs, AC = psi.ALs.clone(), psi.ARs.clone(), psi.AC.clone()
            log.solver_warn(it, diag, inner_tol)
            # convergence: the energy is stationary
            eps = abs(lam - lam_prev) if lam_prev is not None else 1.0
            lam_prev = lam
            if alg.verbosity >= VERBOSE_ITER:
                log.conv(it, lam, eps)
            if eps < alg.tol:
                break
        else:
            log.cancel(it, lam, eps)
        GLs = compute_left_envs(ALs, Ws, left_boundary(w, D, dtype, device))
    return psi, FiniteEnv(GLs, GRs), eps
