"""Infinite Hamiltonian environments (counterpart of
mpskit_tpu/environments/infinite_ham.py): the left/right FSM-level fixed
points of the unit-cell transfer operator.

The FSM is walked level by level on the host. Identity diagonals are solved
as regularized geometric series by GMRES, scalar or general diagonals by
plain GMRES, zero diagonals by one accumulation pass around the cell. The
left and right walks run together (`calc_envs_paired`): the JAX `vmap`
over the (L, R) pair is a leading axis of size 2 in the einsums, which
take any leading batch axes.

Conventions: GLs[i] = env left of site i, GRs[i] = env right of site i;
pairing(v, cap) = einsum('xy,xy->'); caps from InfiniteMPS.rho_right/left.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..linalg.gmres import linsolve_info
from ..operators.mpo import DIAG_IDENTITY, DIAG_ZERO, MPOHamiltonian
from ..states.infinitemps import InfiniteMPS
from ..utils.trace import span
from .finite import stack_W

# Krylov shape of the geometric-series solves (same values as the JAX
# package, which chose short restart cycles on its TPU; not re-tuned for
# the card)
_ENV_RESTART = 12
_ENV_MAXITER = 100


def pairing(v, cap):
    return torch.einsum("...xy,...xy->...", v, cap)


def transfer_left_block(v, Wab, A_ket, A_bra):
    """Single FSM-block left transfer: v (..., D, D), Wab (..., d, d)."""
    t = torch.einsum("...xy,...ytn->...xtn", v, A_ket)
    t = torch.einsum("...xtn,...st->...xsn", t, Wab)
    return torch.einsum("...xsm,...xsn->...mn", A_bra.conj(), t)


def transfer_right_block(v, Wab, A_ket, A_bra):
    t = torch.einsum("...ytn,...mn->...ytm", A_ket, v)
    t = torch.einsum("...ytm,...st->...ysm", t, Wab)
    return torch.einsum("...xsm,...ysm->...xy", A_bra.conj(), t)


def _source_col_left(GL_i, Wcol, A, A_bra=None):
    """Contributions into one FSM level from all lower levels: GL_i
    (..., w, D, D), Wcol (..., w, d, d) with the diagonal entry zeroed.
    Folding the small W column into GL first costs d^2 D^3 + d D^3 instead
    of 2 w d D^3 (the JAX package's planner order). A_bra (default A) may
    be a slice of A's columns: the output's rows are then that slice."""
    A_bra = A if A_bra is None else A_bra
    t = torch.einsum("...axy,...ast->...xyst", GL_i, Wcol)   # w d^2 D^2
    t = torch.einsum("...xyst,...xsm->...ytm", t, A_bra.conj())  # d^2 D^3
    return torch.einsum("...ytm,...ytn->...mn", t, A)        # d D^3


def _source_row_right(GR_i, Wrow, A):
    """Right-moving: contributions into one level from all higher levels:
    GR_i (..., w, D, D), Wrow (..., w, d, d) with the diagonal zeroed."""
    t = torch.einsum("...bmn,...bst->...mnst", GR_i, Wrow)
    t = torch.einsum("...mnst,...xsm->...ntx", t, A.conj())
    return torch.einsum("...ntx,...ytn->...xy", t, A)


@dataclasses.dataclass(frozen=True)
class InfiniteHamEnv:
    GLs: torch.Tensor        # (L, w, D, D)
    GRs: torch.Tensor        # (L, w, D, D)
    e_density: torch.Tensor  # 0-dim, energy per site
    # worst relative residual over the geometric-series GMRES solves (a
    # host float: the solves read it for their exit tests)
    resid: float = 0.0

    def leftenv(self, i):
        return self.GLs[i]

    def rightenv(self, i):
        return self.GRs[i]


def _regularize(x, caps, eye, mask):
    """Project the diverging identity component out of the members of the
    pair whose `mask` entry is 1: x - <x, cap> 1."""
    return x - (mask * pairing(x, caps))[:, None, None] * eye


def calc_envs_paired(psi: InfiniteMPS, H: MPOHamiltonian, tol=1e-12,
                     GL_init=None, GR_init=None, split=None):
    """Both environment families in one direction-batched walk.

    transfer_right(v, W, A) == transfer_left(v, W, A~) and
    _source_row_right(G, W, A) == _source_col_left(G, W, A~), with A~ = A
    with its virtual legs swapped, turn the right walk into a left walk over
    the reversed, leg-swapped unit cell. Level b=k of the left walk and
    level a=w-1-k of the right walk are then solved together as one
    block-diagonal geometric-series GMRES on (2, D, D) operands. Returns
    (GLs, GRs, e_cell, resid). With a `parallel.split.BondSplit` the
    walk's D^3 products run on this rank's slice of the bond axis."""
    block = transfer_left_block if split is None else split.transfer_left_block
    source = _source_col_left if split is None else split.source_col_left
    L, D = psi.period, psi.D
    w = H.odim
    dtype, device = psi.dtype, psi.device
    Ws = stack_W(H, L, dtype, device)                  # (L, w, w, d, d)
    # right walk in left form: reversed site order, virtual legs swapped
    AR_t = torch.flip(psi.AR, (0,)).permute(0, 3, 2, 1)
    A_eff = torch.stack([psi.AL, AR_t], dim=1)         # (L, 2, D, d, D)

    eye = torch.eye(D, dtype=dtype, device=device)
    GLs = torch.zeros((L, w, D, D), dtype=dtype, device=device)
    GLs[:, 0] = eye
    GRs = torch.zeros((L, w, D, D), dtype=dtype, device=device)
    GRs[:, w - 1] = eye
    caps = torch.stack([psi.rho_right(L - 1), psi.rho_left(L - 1)])
    e_cell = torch.zeros((), dtype=dtype, device=device)
    resid = 0.0

    for k in range(1, w):
        b, a = k, w - 1 - k                 # left level, right level
        Wd_eff = torch.stack([Ws[:, b, b], torch.flip(Ws[:, a, a], (0,))],
                             dim=1)                      # (L, 2, d, d)
        WcL = Ws[:, :, b].clone()
        WcL[:, b] = 0
        WcR = Ws[:, a, :].clone()
        WcR[:, a] = 0
        Wc_eff = torch.stack([WcL, torch.flip(WcR, (0,))], dim=1)
        G_eff = torch.stack([GLs, torch.flip(GRs, (0,))], dim=1)
        # the sources from the lower levels do not depend on this level's
        # value: one evaluation serves both passes around the cell
        srcs = [source(G_eff[i], Wc_eff[i], A_eff[i]) for i in range(L)]

        # (the closures below are used within this level only)
        def cycle(x):
            """One pass around the cell; returns the value at every bond
            after site i, stacked (L, 2, D, D)."""
            xs = []
            for i in range(L):
                x = srcs[i] + block(x, Wd_eff[i], A_eff[i], A_eff[i])
                xs.append(x)
            return torch.stack(xs)

        def diag_cycle(x):
            for i in range(L):
                x = block(x, Wd_eff[i], A_eff[i], A_eff[i])
            return x

        F = cycle(torch.zeros((2, D, D), dtype=dtype, device=device))[-1]
        kindL, kindR = H.diag_class[b], H.diag_class[a]
        if kindL == DIAG_IDENTITY and b == w - 1:
            e_cell = pairing(F[0], caps[0])

        if kindL == DIAG_ZERO and kindR == DIAG_ZERO:
            x0 = F
        else:
            # only identity diagonals have the diverging rank-1 component
            # projected out
            mask = torch.tensor([kindL == DIAG_IDENTITY,
                                 kindR == DIAG_IDENTITY], device=device
                                ).to(dtype)

            def matvec_reg(x):
                return _regularize(diag_cycle(x), caps, eye, mask)

            guess = None
            if GL_init is not None and GR_init is not None:
                guess = _regularize(
                    torch.stack([GL_init[0, b], GR_init[L - 1, a]]), caps,
                    eye, mask)
            x0, r = linsolve_info(matvec_reg, _regularize(F, caps, eye, mask),
                                  x0=guess, a0=1.0, a1=-1.0, tol=tol,
                                  restart=_ENV_RESTART, maxiter=_ENV_MAXITER,
                                  stall_exit=True)
            resid = max(resid, r)

        # propagate around the cell to fill every bond
        xs_all = cycle(x0)
        GL_b = torch.cat([x0[0][None], xs_all[:-1, 0]])
        xs_r = torch.flip(xs_all[:, 1], (0,))   # xs_r[i] = value at bond i-1
        GR_a = torch.cat([xs_r[1:], x0[1][None]])
        if kindL == DIAG_IDENTITY:
            bond_caps = torch.roll(psi.rho_rights(), 1, dims=0)
            GL_b = GL_b - pairing(GL_b, bond_caps)[:, None, None] * eye
        if kindR == DIAG_IDENTITY:
            GR_a = GR_a - pairing(GR_a, psi.rho_lefts())[:, None, None] * eye
        GLs[:, b] = GL_b
        GRs[:, a] = GR_a

    return GLs, GRs, e_cell, resid


def hamiltonian_environments(psi: InfiniteMPS, H: MPOHamiltonian,
                             tol=1e-12, env_init=None,
                             split=None) -> InfiniteHamEnv:
    """Both environment families: the effective Hamiltonian at site i uses
    (GLs[i], GRs[i]), the zero-site (bond i) one (GLs[i+1], GRs[i]).

    `env_init` (a previous InfiniteHamEnv) warm-starts the geometric-series
    solves. The tolerance is floored at 10 sqrt(2 D^2) eps of the working
    dtype, the attainable true-residual level (the JAX package measured
    2.5e-4 relative at D=256 float32, within 15 % of this model): with an
    unreachable tolerance every solve would spend its stall-detection
    cycles finding the floor. `split`: see `calc_envs_paired`."""
    with span("envs", "infinite"):
        GL0 = None if env_init is None else env_init.GLs
        GR0 = None if env_init is None else env_init.GRs
        rdt = psi.AL.real.dtype if psi.AL.is_complex() else psi.dtype
        tol = max(float(tol),
                  10 * math.sqrt(2 * psi.D * psi.D) * torch.finfo(rdt).eps)
        GLs, GRs, eL, r = calc_envs_paired(psi, H, tol, GL_init=GL0,
                                           GR_init=GR0, split=split)
        return InfiniteHamEnv(GLs, GRs, eL.real / psi.period, r)
