"""Transfer-matrix contractions (counterpart of
mpskit_tpu/transfermatrix/transfer.py): each push is three pairwise
einsums written so that the two large ones are w*d*D^3 matrix products.

Index conventions: A[l, p, r]; W[a, b, s, t] with s = phys-out (bra side),
t = phys-in (ket side); GL[a, l_bra, l_ket]; GR[b, r_bra, r_ket].
"""

from __future__ import annotations

import torch

from ..utils.trace import span


def transfer_left(v, A_ket, A_bra):
    """v[l_bra, l_ket] -> v'[m_bra, m_ket] through one site."""
    t = torch.einsum("xy,ytn->xtn", v, A_ket)
    return torch.einsum("xtm,xtn->mn", A_bra.conj(), t)


def transfer_right(v, A_ket, A_bra):
    """v[r_bra, r_ket] -> v'[l_bra, l_ket] through one site."""
    t = torch.einsum("ytn,mn->ytm", A_ket, v)
    return torch.einsum("xtm,ytm->xy", A_bra.conj(), t)


def transfer_left_mpo(GL, W, A_ket, A_bra):
    """GL (w, D, D) -> (w', D, D) through site tensors and W (w, w', d, d)."""
    with span("push"):
        t = torch.einsum("axy,ytn->axtn", GL, A_ket)        # w d D^3
        t = torch.einsum("axtn,abst->bxsn", t, W)           # w^2 d^2 D^2
        return torch.einsum("xsm,bxsn->bmn", A_bra.conj(), t)  # w d D^3


def transfer_right_mpo(GR, W, A_ket, A_bra):
    """GR (w', D, D) -> (w, D, D) through site tensors and W (w, w', d, d)."""
    with span("push"):
        t = torch.einsum("ytn,bmn->bytm", A_ket, GR)
        t = torch.einsum("bytm,abst->aysm", t, W)
        return torch.einsum("xsm,aysm->axy", A_bra.conj(), t)


def mps_transfer_matvec_left(As_ket, As_bra):
    """v -> v . T for the product transfer matrix of a unit cell: the left
    action, a host loop through the stacked site tensors left to right."""
    def mv(v):
        for Ak, Ab in zip(As_ket, As_bra):
            v = transfer_left(v, Ak, Ab)
        return v

    return mv


def mps_transfer_matvec_right(As_ket, As_bra):
    """T . v, the right action: the same loop from the last site back."""
    def mv(v):
        for i in range(len(As_ket) - 1, -1, -1):
            v = transfer_right(v, As_ket[i], As_bra[i])
        return v

    return mv
