"""Left <-> right gauge conversion of quasiparticle states (counterpart of
mpskit_tpu/states/qp_gauge.py).

|Phi(B)> = sum_n e^{ipn} |AL..AL B_n AR..AR> is invariant under the gauge
shift B_n -> B_n + e^{ip} AL_n Y_{n+1} - Y_n AR_n, with Y on the bonds
(periodic over the cell for infinite states, zero at the ends of finite
chains). The right gauge condition gives the bond recursion

    Y_n = t_n + e^{ip} M_n(Y_{n+1}),  t_n = B_n AR_n^dag,
    M_n(Y) = AL_n Y AR_n^dag,

a backward substitution on finite chains and a cyclic linear problem
(GMRES) on infinite ones; the right -> left conversion is the mirror
recursion running forward. The JAX package shifts Y around the cell with
rolls; here Ynext[n] = Y[n+1 mod L] and the shifted sources are written
with the same `torch.roll` shifts, and the finite substitutions are host
loops that write each bond's Y to its seat.
"""

from __future__ import annotations

import torch

from ..environments.qp import _phase
from ..linalg.gmres import linsolve
from .finitemps import physical_bond_dims
from .quasiparticle import (
    FiniteQP, FiniteQPRight, LeftGaugedQP, RightGaugedQP,
    finite_null_spaces, finite_right_null_spaces, null_spaces,
    right_null_spaces,
)


def _shifted(AL, AR, B, Y, ph):
    """B + e^{ip} AL Y_{n+1} - Y_n AR (the gauge-shifted excitation)."""
    Ynext = torch.roll(Y, -1, dims=0)   # Ynext[n] = Y[n+1 mod L]
    return (B + ph * torch.einsum("nlpa,nar->nlpr", AL, Ynext)
            - torch.einsum("nla,napr->nlpr", Y, AR))


# ----------------------------------------------------------------------------
# infinite
# ----------------------------------------------------------------------------

def left_to_right_gauge(qp: LeftGaugedQP, tol: float = 1e-12
                        ) -> RightGaugedQP:
    """The physically identical RightGaugedQP of an infinite
    LeftGaugedQP."""
    AL, AR = qp.left_gs.AL, qp.right_gs.AR
    B = qp.bs()
    ph = _phase(qp.momentum, B.dtype)
    t = torch.einsum("nlpr,nmpr->nlm", B, AR.conj())

    def M(Y):
        return ph * torch.einsum("nlpa,nab,nmpb->nlm", AL,
                                 torch.roll(Y, -1, dims=0), AR.conj())

    # (1 - e^{ip} M_roll) Y = t
    Y = linsolve(M, t, a0=1.0, a1=-1.0, tol=tol)
    Bp = _shifted(AL, AR, B, Y, ph)
    VRs = right_null_spaces(AR)
    Xs = torch.einsum("nlpr,nkpr->nlk", Bp, VRs.conj())
    return RightGaugedQP(Xs, VRs, qp.left_gs, qp.right_gs, qp.momentum,
                         qp.trivial)


def right_to_left_gauge(qp: RightGaugedQP, tol: float = 1e-12
                        ) -> LeftGaugedQP:
    """The physically identical LeftGaugedQP of an infinite
    RightGaugedQP."""
    AL, AR = qp.left_gs.AL, qp.right_gs.AR
    B = qp.bs()
    ph = _phase(qp.momentum, B.dtype)
    # left gauge condition: s_n + e^{ip} Y_{n+1} - N_n(Y_n) = 0 with
    # s_n = AL_n^dag B_n, N_n(Y) = AL_n^dag Y AR_n
    s = torch.einsum("nlpm,nlpr->nmr", AL.conj(), B)

    def G(Y):
        per = torch.einsum("nlpm,nla,napr->nmr", AL.conj(), Y, AR)
        return torch.roll(per, 1, dims=0)   # G(Y)[m] = N_{m-1}(Y_{m-1})

    # e^{ip} Y - G(Y) = -roll(s, +1)
    Y = linsolve(G, -torch.roll(s, 1, dims=0), a0=ph, a1=-1.0, tol=tol)
    Bp = _shifted(AL, AR, B, Y, ph)
    VLs = null_spaces(AL)
    Xs = torch.einsum("nlpk,nlpr->nkr", VLs.conj(), Bp)
    return LeftGaugedQP(Xs, VLs, qp.left_gs, qp.right_gs, qp.momentum,
                        qp.trivial)


# ----------------------------------------------------------------------------
# finite
# ----------------------------------------------------------------------------

def _bond_masks(L, d, D, dtype, device):
    """(L+1, D, D) masks of the supported bond blocks of a padded finite
    MPS: the padded gauge tensors carry orthonormal junk in their
    unsupported rows and columns, so the bond recursions re-mask every
    step."""
    dims = physical_bond_dims(L, d, D)
    m = torch.zeros((L + 1, D, D), dtype=dtype, device=device)
    for n in range(L + 1):
        m[n, : int(dims[n]), : int(dims[n])] = 1
    return m


def finite_left_to_right_gauge(qp: FiniteQP) -> FiniteQPRight:
    """Backward substitution Y_n = t_n + M_n(Y_{n+1}) with Y_L = 0; Y_0
    comes out zero because a left-gauged B is orthogonal to the ground
    state."""
    AL, AR = qp.ALs, qp.ARs
    B = qp.bs()
    L, D, d = AL.shape[0], AL.shape[1], AL.shape[2]
    bm = _bond_masks(L, d, D, B.dtype, B.device)
    t = torch.einsum("nlpr,nmpr->nlm", B, AR.conj())
    Ys = torch.zeros((L + 1, D, D), dtype=B.dtype, device=B.device)
    for n in range(L - 1, -1, -1):
        Ys[n] = (t[n] + torch.einsum("lpa,ab,mpb->lm", AL[n], Ys[n + 1],
                                     AR[n].conj())) * bm[n]
    Bp = (B + torch.einsum("nlpa,nar->nlpr", AL, Ys[1:])
          - torch.einsum("nla,napr->nlpr", Ys[:L], AR))
    VRs, mask = finite_right_null_spaces(AR, D, d)
    Xs = torch.einsum("nlpr,nkpr->nlk", Bp, VRs.conj()) * mask.to(B.dtype)
    return FiniteQPRight(Xs, VRs, AL, AR, mask)


def finite_right_to_left_gauge(qp: FiniteQPRight) -> FiniteQP:
    """Forward substitution Y_{n+1} = N_n(Y_n) - s_n with Y_0 = 0."""
    AL, AR = qp.ALs, qp.ARs
    B = qp.bs()
    L, D, d = AL.shape[0], AL.shape[1], AL.shape[2]
    bm = _bond_masks(L, d, D, B.dtype, B.device)
    s = torch.einsum("nlpm,nlpr->nmr", AL.conj(), B)
    Ys = torch.zeros((L + 1, D, D), dtype=B.dtype, device=B.device)
    for n in range(L):
        Ys[n + 1] = (torch.einsum("lpm,la,apr->mr", AL[n].conj(), Ys[n],
                                  AR[n]) - s[n]) * bm[n + 1]
    Bp = (B + torch.einsum("nlpa,nar->nlpr", AL, Ys[1:])
          - torch.einsum("nla,napr->nlpr", Ys[:L], AR))
    VLs, mask = finite_null_spaces(AL, D, d)
    Xs = torch.einsum("nlpk,nlpr->nkr", VLs.conj(), Bp) * mask.to(B.dtype)
    return FiniteQP(Xs, VLs, AL, AR, mask)
