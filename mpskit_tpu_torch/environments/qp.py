"""Quasiparticle B-environments (counterpart of
mpskit_tpu/environments/qp.py).

lB_i is the mixed environment (ket the right ground state's AR, bra the
left one's AL) at the bond left of site i that holds exactly one B,
phased e^{-ip} per site; rB_i mirrors it to the right with e^{+ip}. The
infinite tails are per-FSM-level cyclic solves: GMRES on the non-zero
diagonal levels, with the rank-1 regularization by the mixed-gauge caps
(l_RL = C, r_RL = conj(C); l_LR = C^dag, r_LR = C^T) on the identity
levels of trivial excitations. The JAX package scans around the cell and
re-seats the scan's outputs with rolls; here the cycle is a host loop that
writes each bond's value to its seat.
"""

from __future__ import annotations

import numpy as np
import torch

from ..linalg.gmres import linsolve
from ..operators.mpo import DIAG_IDENTITY, DIAG_ZERO, MPOHamiltonian
from .finite import stack_W
from .infinite_ham import pairing, transfer_left_block, transfer_right_block


def _phase(p: float, dtype):
    """e^{ip} as a host scalar: complex for a complex dtype; a real dtype
    takes only p = 0 mod pi."""
    if dtype.is_complex:
        return complex(np.exp(1j * p))
    assert abs(np.sin(p)) < 1e-12, \
        "momentum != 0 mod pi requires a complex dtype"
    return float(np.cos(p))


def _src_col_left(env, Wcol, A_ket, A_bra):
    """Push env (w, D, D) into one level through the column Wcol (w, d,
    d): out[m, m'] = sum conj(A_bra)[x,s,m] env[a,x,y] Wcol[a,s,t]
    A_ket[y,t,m']."""
    t = torch.einsum("axy,ytn->axtn", env, A_ket)
    t = torch.einsum("axtn,ast->xsn", t, Wcol)
    return torch.einsum("xsm,xsn->mn", A_bra.conj(), t)


def _src_row_right(env, Wrow, A_ket, A_bra):
    t = torch.einsum("ytn,bmn->bytm", A_ket, env)
    t = torch.einsum("bytm,bst->ysm", t, Wrow)
    return torch.einsum("xsm,ysm->xy", A_bra.conj(), t)


def qp_left_envs(qp, GLs, H: MPOHamiltonian, tol=1e-10):
    """lBs (L, w, D, D); lBs[i] sits at the bond left of site i. GLs are
    the left ground state's environments."""
    L, D, w = qp.period, qp.left_gs.D, H.odim
    dtype, device = qp.left_gs.dtype, qp.left_gs.device
    Ws = stack_W(H, L, dtype, device)
    AL, AR, Bs = qp.left_gs.AL, qp.right_gs.AR, qp.bs()
    phase = _phase(-qp.momentum, dtype)
    # the caps that site i's step projects on sit at the bond after site
    # i, built from C[i] (the JAX package's C rolled by +1, then -1)
    l_caps = qp.left_gs.C
    r_caps = qp.left_gs.C.conj()
    lBs = torch.zeros((L, w, D, D), dtype=dtype, device=device)

    for b in range(w):
        Wdiag = Ws[:, b, b]
        Wcol_off = Ws[:, :, b].clone()
        Wcol_off[:, b] = 0
        Wcol_full = Ws[:, :, b]
        reg = qp.trivial and H.diag_class[b] == DIAG_IDENTITY
        # the sources from the lower levels and from B do not depend on
        # this level's value: one evaluation serves every pass
        srcs = [_src_col_left(lBs[i], Wcol_off[i], AR[i], AL[i])
                + _src_col_left(GLs[i], Wcol_full[i], Bs[i], AL[i])
                for i in range(L)]

        def step(x, i, with_lower=True):
            """The value at the bond left of site i -> the next bond."""
            val = transfer_left_block(x, Wdiag[i], AR[i], AL[i])
            if with_lower:
                val = val + srcs[i]
            val = phase * val
            if reg:
                val = val - pairing(val, r_caps[i]) * l_caps[i]
            return val

        def cycle(x, with_lower=True):
            for i in range(L):
                x = step(x, i, with_lower)
            return x

        F = cycle(torch.zeros((D, D), dtype=dtype, device=device))
        if H.diag_class[b] == DIAG_ZERO:
            x0 = F
        else:
            x0 = linsolve(lambda x: cycle(x, with_lower=False), F, a0=1.0,
                          a1=-1.0, tol=tol)
        x = x0
        for i in range(L):
            lBs[i, b] = x
            x = step(x, i)
    return lBs


def qp_right_envs(qp, GRs, H: MPOHamiltonian, tol=1e-10):
    """rBs (L, w, D, D); rBs[i] sits at the bond right of site i. GRs are
    the right ground state's environments."""
    L, D, w = qp.period, qp.left_gs.D, H.odim
    dtype, device = qp.left_gs.dtype, qp.left_gs.device
    Ws = stack_W(H, L, dtype, device)
    AL, AR, Bs = qp.left_gs.AL, qp.right_gs.AR, qp.bs()
    phase = _phase(qp.momentum, dtype)
    # the caps that site i's step projects on sit at the bond before site
    # i, built from C[i-1]
    C_prev = torch.roll(qp.left_gs.C, 1, dims=0)
    l_caps = C_prev.mH                  # l_LR = C^dag
    r_caps = C_prev.mT                  # r_LR = C^T
    rBs = torch.zeros((L, w, D, D), dtype=dtype, device=device)

    for a in range(w - 1, -1, -1):
        Wdiag = Ws[:, a, a]
        Wrow_off = Ws[:, a, :].clone()
        Wrow_off[:, a] = 0
        Wrow_full = Ws[:, a, :]
        reg = qp.trivial and H.diag_class[a] == DIAG_IDENTITY
        srcs = [_src_row_right(rBs[i], Wrow_off[i], AL[i], AR[i])
                + _src_row_right(GRs[i], Wrow_full[i], Bs[i], AR[i])
                for i in range(L)]

        def step(x, i, with_upper=True):
            """The value at the bond right of site i -> the bond before."""
            val = transfer_right_block(x, Wdiag[i], AL[i], AR[i])
            if with_upper:
                val = val + srcs[i]
            val = phase * val
            if reg:
                val = val - pairing(val, l_caps[i]) * r_caps[i]
            return val

        def cycle(x, with_upper=True):
            for i in range(L - 1, -1, -1):
                x = step(x, i, with_upper)
            return x

        F = cycle(torch.zeros((D, D), dtype=dtype, device=device))
        if H.diag_class[a] == DIAG_ZERO:
            x0 = F
        else:
            x0 = linsolve(lambda x: cycle(x, with_upper=False), F, a0=1.0,
                          a1=-1.0, tol=tol)
        x = x0
        for i in range(L - 1, -1, -1):
            rBs[i, a] = x
            x = step(x, i)
    return rBs


# ----------------------------------------------------------------------------
# finite QP environments: plain partial sums
# ----------------------------------------------------------------------------

def qp_left_envs_finite(qp, GLs, Ws):
    """lBs[i] = B-environment at the bond left of site i; lBs[0] = 0."""
    return qp_left_envs_finite_B(qp.bs(), qp.ALs, qp.ARs, GLs, Ws)


def qp_left_envs_finite_B(Bs, ALs, ARs, GLs, Ws):
    """The same from explicit B tensors."""
    L, D, w = ALs.shape[0], ALs.shape[1], Ws.shape[1]
    lBs = torch.empty((L, w, D, D), dtype=ALs.dtype, device=ALs.device)
    x = torch.zeros((w, D, D), dtype=ALs.dtype, device=ALs.device)
    for i in range(L):
        lBs[i] = x
        t = torch.einsum("axy,ytn->axtn", x, ARs[i])
        t = torch.einsum("axtn,abst->bxsn", t, Ws[i])
        xn = torch.einsum("xsm,bxsn->bmn", ALs[i].conj(), t)
        s = torch.einsum("axy,ytn->axtn", GLs[i], Bs[i])
        s = torch.einsum("axtn,abst->bxsn", s, Ws[i])
        x = xn + torch.einsum("xsm,bxsn->bmn", ALs[i].conj(), s)
    return lBs


def qp_right_envs_finite(qp, GRs, Ws):
    """rBs[i] = B-environment at the bond right of site i; rBs[L-1] = 0."""
    return qp_right_envs_finite_B(qp.bs(), qp.ALs, qp.ARs, GRs, Ws)


def qp_right_envs_finite_B(Bs, ALs, ARs, GRs, Ws):
    """The same from explicit B tensors; GRs[i+1] is the environment right
    of site i."""
    L, D, w = ALs.shape[0], ALs.shape[1], Ws.shape[1]
    rBs = torch.empty((L, w, D, D), dtype=ALs.dtype, device=ALs.device)
    x = torch.zeros((w, D, D), dtype=ALs.dtype, device=ALs.device)
    for i in range(L - 1, -1, -1):
        rBs[i] = x
        t = torch.einsum("ytn,bmn->bytm", ALs[i], x)
        t = torch.einsum("bytm,abst->aysm", t, Ws[i])
        xn = torch.einsum("xsm,aysm->axy", ARs[i].conj(), t)
        s = torch.einsum("ytn,bmn->bytm", Bs[i], GRs[i + 1])
        s = torch.einsum("bytm,abst->aysm", s, Ws[i])
        x = xn + torch.einsum("xsm,aysm->axy", ARs[i].conj(), s)
    return rBs
