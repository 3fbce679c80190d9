"""Quasiparticle excitations over transfer MPOs, the 2D statmech boundaries
(counterpart of mpskit_tpu/algorithms/excitations_statmech.py), on one row
and on a multi-row MPSMultiline / MPOMultiline.

The MPO is rescaled by its leading eigenvalue per site, O -> O /
lambda^(1/L), so the channel transfer has unit dominant eigenvalue and the
excitation eigenvalues are relative to the ground channel (dispersion
epsilon(p) = -log|lambda_qp(p)|). The eigenproblem is non-Hermitian
(dominant Arnoldi); the B-environments' geometric series are regularized
by the dominant eigenpairs of the mixed AR/AL channels. The JAX package
vmaps the per-site contractions; here they are host loops over the cell.
Start vectors come from a `torch.Generator` on the state's device in place
of the JAX package's PRNG key; without one every momentum starts from a
generator seeded 0, as the JAX package's one key gives every momentum the
same start.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..environments.infinite_mpo import (
    cell_transfer_left, cell_transfer_right, mpo_environments, stack_O,
)
from ..environments.qp import _phase
from ..linalg.arnoldi import dominant_eigs
from ..linalg.gmres import linsolve
from ..operators.multiline import MPOMultiline
from ..states.infinitemps import InfiniteMPS
from ..states.multiline import MPSMultiline
from ..states.quasiparticle import LeftGaugedQP
from ..transfermatrix.transfer import transfer_left_mpo, transfer_right_mpo
from .derivatives import ac_apply
from .excitations import _generator


def pairing(v, cap):
    """Full contraction of (w, D, D) channel vectors."""
    return torch.einsum("axy,axy->", v, cap)


def _channel_caps(Os, A_ket, A_bra, tol: float = 1e-10):
    """Dominant (left, right) eigenpair of an MPO channel (ket and bra
    gauges, or rows, may differ), normalized so that pairing(l, r) = 1.
    Returns (lam, l, r)."""
    w, D = Os.shape[1], A_ket.shape[1]
    v0 = torch.ones((w, D, D), dtype=A_ket.dtype, device=A_ket.device)
    a = dominant_eigs(cell_transfer_left(Os, A_ket, A_bra), v0, 30, 60, tol)
    b = dominant_eigs(cell_transfer_right(Os, A_ket, A_bra), v0, 30, 60, tol)
    l, r = a.eigenvector, b.eigenvector
    return a.eigenvalue, l, r / pairing(l, r)


def _b_envs(Os, GLs, GRs, A_ket_l, A_bra_l, A_ket_r, A_bra_r, capsL, capsR,
            Bs, phase):
    """(lBs, rBs), each (L, w, D, D): lBs[i] at the bond left of site i with
    one B to its left (ket AR, bra AL, e^{-ip} per site), rBs[i] right of
    site i (ket AL, bra AR, e^{+ip} per site): a cyclic solve at the cell
    edge projected off the channel's dominant pair, then propagated. The
    left caps project with (l, r) as pairing(x, r) l, the right ones with
    pairing(x, l) r."""
    L = Os.shape[0]
    dtype, device = Bs.dtype, Bs.device
    w, D = Os.shape[1], Bs.shape[1]
    phase_r = phase.conjugate() if isinstance(phase, complex) else phase

    def step_l(x, i, with_B=True):
        xn = transfer_left_mpo(x, Os[i], A_ket_l[i], A_bra_l[i])
        if with_B:
            xn = xn + transfer_left_mpo(GLs[i], Os[i], Bs[i], A_bra_l[i])
        return xn * phase

    def step_r(x, i, with_B=True):
        xn = transfer_right_mpo(x, Os[i], A_ket_r[i], A_bra_r[i])
        if with_B:
            xn = xn + transfer_right_mpo(GRs[i], Os[i], Bs[i], A_bra_r[i])
        return xn * phase_r

    def proj_l(x):
        return x - pairing(x, capsL[1]) * capsL[0]

    def proj_r(x):
        return x - pairing(x, capsR[0]) * capsR[1]

    def cycle_l(x, with_B):
        for i in range(L):
            x = step_l(x, i, with_B)
        return x

    def cycle_r(x, with_B):
        for i in range(L - 1, -1, -1):
            x = step_r(x, i, with_B)
        return x

    zero = torch.zeros((w, D, D), dtype=dtype, device=device)
    x = linsolve(lambda v: proj_l(cycle_l(v, False)),
                 proj_l(cycle_l(zero, True)), a0=1.0, a1=-1.0, tol=1e-9)
    lBs = [x]
    for i in range(L - 1):
        lBs.append(proj_l(step_l(lBs[-1], i)))
    x = linsolve(lambda v: proj_r(cycle_r(v, False)),
                 proj_r(cycle_r(zero, True)), a0=1.0, a1=-1.0, tol=1e-9)
    rBs = [x]
    for i in range(L - 1, 0, -1):
        rBs.insert(0, proj_r(step_r(rBs[0], i)))
    return torch.stack(lBs), torch.stack(rBs)


def _projected_apply(GLs, Os, GRs, Bs, lBs, rBs, ALs, ARs, VLs):
    """The three ac_apply-shaped terms of each site projected onto the
    null-space basis VLs: (L, D(d-1), D)."""
    out = []
    for i in range(Os.shape[0]):
        y = ac_apply(GLs[i], Os[i], GRs[i], Bs[i])
        y = y + ac_apply(lBs[i], Os[i], GRs[i], ARs[i])
        y = y + ac_apply(GLs[i], Os[i], rBs[i], ALs[i])
        out.append(torch.einsum("lpk,lpr->kr", VLs[i].conj(), y))
    return torch.stack(out)


def excitations_boundary(O, momenta, psi: InfiniteMPS, envs=None,
                         generator: torch.Generator = None,
                         krylovdim: int = 30, tol: float = 1e-7):
    """Dominant excitation eigenvalue of the per-site normalized transfer
    operator at each momentum. Returns (lambdas, qps): lambdas an
    (n_momenta,) CPU tensor, qps a list of LeftGaugedQP."""
    if np.isscalar(momenta):
        momenta = [momenta]
    L, dtype = psi.period, psi.dtype
    if envs is None:
        envs = mpo_environments(psi, O)
    Os = stack_O(O, L, dtype, psi.device) / envs.lambda_cell ** (1.0 / L)
    capsL = _channel_caps(Os, psi.AR, psi.AL)[1:]
    capsR = _channel_caps(Os, psi.AL, psi.AR)[1:]

    out_l, out_qp = [], []
    for p in momenta:
        phase = _phase(-float(p), dtype)
        qp0 = LeftGaugedQP.random(psi, momentum=float(p),
                                  generator=_generator(generator, psi.device))

        def matvec(Xs):
            Bs = dataclasses.replace(qp0, Xs=Xs).bs()
            lBs, rBs = _b_envs(Os, envs.GLs, envs.GRs, psi.AR, psi.AL,
                               psi.AL, psi.AR, capsL, capsR, Bs, phase)
            return _projected_apply(envs.GLs, Os, envs.GRs, Bs, lBs, rBs,
                                    psi.AL, psi.AR, qp0.VLs)

        res = dominant_eigs(matvec, qp0.Xs, krylovdim, 60, tol)
        out_l.append(res.eigenvalue)
        out_qp.append(dataclasses.replace(qp0, Xs=res.eigenvector))
    return torch.from_numpy(np.array(out_l)), out_qp


def excitations_boundary_multiline(O: MPOMultiline, momenta,
                                   psi: MPSMultiline, envs=None,
                                   generator: torch.Generator = None,
                                   krylovdim: int = 30, tol: float = 1e-7):
    """Multi-row quasiparticle excitations: row r's transfer maps row r's B
    tensors into row r+1's tangent space (the coupling of the multi-row
    boundary VUMPS), so the eigenproblem runs over the stacked per-row X
    blocks with a row shift after each application. For R identical rows
    the dominant |lambda| equals the single-row value. `envs` is accepted
    for signature parity: the mixed row environments are rebuilt. Returns
    (lambdas (n_momenta,) CPU tensor, per-momentum lists of per-row
    LeftGaugedQP)."""
    if np.isscalar(momenta):
        momenta = [momenta]
    if not (isinstance(psi, MPSMultiline) and isinstance(O, MPOMultiline)
            and O.nrows == psi.nrows):
        raise TypeError("excitations_boundary_multiline needs an "
                        "MPSMultiline and an MPOMultiline of as many rows")
    R, L = psi.nrows, psi.period
    dtype, device = psi.rows[0].dtype, psi.rows[0].device

    # per-row mixed environments (ket row r, bra row r+1), normalized row
    # MPOs and the caps of the mixed channels
    Os, envs_r, capsL, capsR = [], [], [], []
    for r in range(R):
        ket, bra = psi.rows[r], psi.rows[(r + 1) % R]
        Or = stack_O(O.row(r), L, dtype, device)
        env = mpo_environments(ket, Or, psi_bra=bra)
        On = Or / env.lambda_cell ** (1.0 / L)
        Os.append(On)
        envs_r.append(env)
        capsL.append(_channel_caps(On, ket.AR, bra.AL)[1:])
        capsR.append(_channel_caps(On, ket.AL, bra.AR)[1:])

    out_l, out_qp = [], []
    for p in momenta:
        phase = _phase(-float(p), dtype)
        gen = _generator(generator, device)
        qp0 = [LeftGaugedQP.random(psi.rows[r], momentum=float(p),
                                   generator=gen) for r in range(R)]

        def matvec(Xs_stack):
            outs = []
            for r in range(R):
                ket, bra = psi.rows[r], psi.rows[(r + 1) % R]
                env = envs_r[r]
                Bs = dataclasses.replace(qp0[r], Xs=Xs_stack[r]).bs()
                lBs, rBs = _b_envs(Os[r], env.GLs, env.GRs, ket.AR, bra.AL,
                                   ket.AL, bra.AR, capsL[r], capsR[r], Bs,
                                   phase)
                outs.append(_projected_apply(
                    env.GLs, Os[r], env.GRs, Bs, lBs, rBs, ket.AL, ket.AR,
                    qp0[(r + 1) % R].VLs))
            # row r's output lives in row r+1's tangent space
            return torch.stack([outs[(r - 1) % R] for r in range(R)])

        res = dominant_eigs(matvec, torch.stack([q.Xs for q in qp0]),
                            krylovdim, 60, tol)
        out_l.append(res.eigenvalue)
        out_qp.append([dataclasses.replace(qp0[r], Xs=res.eigenvector[r])
                       for r in range(R)])
    return torch.from_numpy(np.array(out_l)), out_qp
