"""Uniform gauging of infinite MPS (counterpart of
mpskit_tpu/states/gauging.py): the fixed-point iteration of alternating
Arnoldi-accelerated transfer-matrix eigensolves and QR sweeps through the
unit cell. The JAX `lax.while_loop` is a host loop here; it reads its error
once per iteration, and its QR sweep is a host loop over the sites.
"""

from __future__ import annotations

import torch

from ..config import Defaults
from ..linalg.arnoldi import dominant_eigs
from ..tensors.ops import leftorth, lq_pos, qr_pos, rightorth
from ..transfermatrix.transfer import transfer_left, transfer_right
from ..utils.sync import to_host


def _unit(C):
    return C / torch.clamp(torch.linalg.vector_norm(C), min=1e-30)


def _left_qr_sweep(A, C_end):
    """One QR sweep: C[i-1] A[i] = AL[i] C[i], normalized per site.
    Returns (ALs, Cs, C_end)."""
    ALs, Cs = [], []
    C = C_end
    for Ai in A:
        AL, C = leftorth(torch.einsum("lm,mpr->lpr", C, Ai))
        C = _unit(C)
        ALs.append(AL)
        Cs.append(C)
    return torch.stack(ALs), torch.stack(Cs), C


def _right_lq_sweep(A, C_end):
    """One LQ sweep, right to left: A[i] C[i] = C[i-1] AR[i]. Returns
    (ARs, Cs, C_end) with Cs[i] the bond right of site i and C_end the one
    left of site 0 (= Cs[L-1] of the periodic cell)."""
    L = A.shape[0]
    ARs, Cs_prev = [None] * L, [None] * L
    C = C_end
    for i in range(L - 1, -1, -1):
        C, ARs[i] = rightorth(torch.einsum("lpm,mr->lpr", A[i], C))
        C = _unit(C)
        Cs_prev[i] = C            # C[i-1]
    return torch.stack(ARs), torch.stack(Cs_prev[1:] + [C]), C


def _mixed_cell_transfer_left(A_ket, A_bra):
    def mv(v):
        for Ak, Ab in zip(A_ket, A_bra):
            v = transfer_left(v, Ak, Ab)
        return v

    return mv


def _mixed_cell_transfer_right(A_ket, A_bra):
    def mv(v):
        for i in range(A_ket.shape[0] - 1, -1, -1):
            v = transfer_right(v, A_ket[i], A_bra[i])
        return v

    return mv


def _fixed_point_loop(sweep, accel, A, C0, tol, maxiter, eig_miniter):
    """The gauge-fix iteration shared by both directions: sweep, then
    re-seed from the Arnoldi fixed point once it >= eig_miniter. Stops on
    convergence, at maxiter, or on stagnation: 3 consecutive accelerated
    iterations without a 10 % error reduction. In float32 the error floor
    sits far above tol, and without this guard every call would burn
    maxiter Arnoldi + QR cycles (the JAX package measured 94 % of a D=256
    float32 VUMPS iteration)."""
    Xs, Cs, C_end = sweep(A, _unit(C0))
    err, stall, it = float("inf"), 0, 0
    while it < maxiter and err > tol and stall < 3:
        C_seed = accel(Xs, C_end, err) if it >= eig_miniter else C_end
        Xs, Cs, C_end = sweep(A, C_seed)
        err_new = to_host(torch.linalg.vector_norm(C_end - C_seed))[0]
        stall = stall + 1 if (err_new > 0.9 * err and it >= eig_miniter) else 0
        err = err_new
        it += 1
    return Xs, Cs, err


def uniform_leftorth(A, C0, tol: float = Defaults.tolgauge,
                     maxiter: int = Defaults.gauge_maxiter,
                     eig_miniter: int = Defaults.eig_miniter):
    """(AL, C, err) with C[i-1] A[i] ∝ AL[i] C[i], AL left-isometric."""

    def accel(ALs, C_end, err):
        res = dominant_eigs(_mixed_cell_transfer_left(A, ALs), C_end, 20, 1,
                            max(err * err, 1e-15))
        _, R = qr_pos(res.eigenvector)
        return _unit(R)

    return _fixed_point_loop(_left_qr_sweep, accel, A, C0, tol, maxiter,
                             eig_miniter)


def uniform_rightorth(A, C0, tol: float = Defaults.tolgauge,
                      maxiter: int = Defaults.gauge_maxiter,
                      eig_miniter: int = Defaults.eig_miniter):
    """(AR, C, err) with A[i] C[i] ∝ C[i-1] AR[i], AR right-isometric."""

    def accel(ARs, C_end, err):
        # the mixed right-transfer fixed point is C^T (the bra index pairs
        # with AR's left bond), so seed and read back transposed
        res = dominant_eigs(_mixed_cell_transfer_right(A, ARs), C_end.mT, 20,
                            1, max(err * err, 1e-15))
        L, _ = lq_pos(res.eigenvector.mT)
        return _unit(L)

    return _fixed_point_loop(_right_lq_sweep, accel, A, C0, tol, maxiter,
                             eig_miniter)


def regauge_ACC(AC, C):
    """min_AL ||AC - AL C||: AL = Q_AC Q_C^dag from QRpos of both. AC
    (..., D, d, D), C (..., D, D); leading axes are a batch (the unit
    cell)."""
    D, d = AC.shape[-3], AC.shape[-2]
    Q_AC, _ = qr_pos(AC.reshape(*AC.shape[:-3], D * d, D))
    Q_C, _ = qr_pos(C)
    return (Q_AC @ Q_C.mH).reshape(AC.shape)


def regauge_CAC(C, AC):
    """min_AR ||AC - C AR||: the mirror of regauge_ACC with LQpos."""
    D, d = AC.shape[-3], AC.shape[-2]
    _, Q_AC = lq_pos(AC.reshape(*AC.shape[:-3], D, d * D))
    _, Q_C = lq_pos(C)
    return (Q_C.mH @ Q_AC).reshape(AC.shape)
