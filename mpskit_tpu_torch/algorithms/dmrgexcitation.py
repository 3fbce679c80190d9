"""Penalty-method excited states, `FiniteExcited` (counterpart of
mpskit_tpu/algorithms/dmrgexcitation.py).

Excited states come from ground-state DMRG on H + weight * sum_k
|psi_k><psi_k|: the projector penalty enters every local eigensolve
through overlap environments with the states already found. The JAX
package runs a sweep as two `lax.scan`s; here they are host loops that
write each output to its seat, as `dmrg.py` does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import Defaults, matmul_precision
from ..environments.finite import (
    compute_right_envs, left_boundary, right_boundary, stack_W,
)
from ..linalg.lanczos import eigsh_smallest
from ..states.finitemps import FiniteMPS
from ..states.quasiparticle import full_gauges
from ..tensors.ops import leftorth, rightorth
from ..transfermatrix.transfer import (
    transfer_left, transfer_left_mpo, transfer_right, transfer_right_mpo,
)
from ..utils.dynamictols import updatetol
from .derivatives import ac_apply


@dataclasses.dataclass(frozen=True)
class FiniteExcited:
    """Same fields and defaults as the JAX package's."""

    weight: float = 10.0
    tol: float = 1e-8
    maxiter: int = 60
    krylovdim: int = Defaults.krylovdim
    eig_maxrestarts: int = 6
    verbosity: int = Defaults.verbosity


def _boundary_overlap(n_pen, D, dtype, device):
    v = torch.zeros((n_pen, D, D), dtype=dtype, device=device)
    v[:, 0, 0] = 1.0
    return v


def _overlap_left_envs(ALs_pen, ALs):
    """vL[k, i]: the overlap environment left of site i between penalty
    state k (ket) and the current state (bra); (n_pen, L+1, D, D)."""
    n_pen, L, D = ALs_pen.shape[0], ALs.shape[0], ALs.shape[1]
    out = torch.empty((n_pen, L + 1, D, D), dtype=ALs.dtype,
                      device=ALs.device)
    for k in range(n_pen):
        v = _boundary_overlap(1, D, ALs.dtype, ALs.device)[0]
        for i in range(L):
            out[k, i] = v
            v = transfer_left(v, ALs_pen[k, i], ALs[i])
        out[k, L] = v
    return out


def _overlap_right_envs(ARs_pen, ARs):
    """vR[k, i+1]: the overlap environment right of site i; vR[k, 0] is
    the contraction of the whole chain."""
    n_pen, L, D = ARs_pen.shape[0], ARs.shape[0], ARs.shape[1]
    out = torch.empty((n_pen, L + 1, D, D), dtype=ARs.dtype,
                      device=ARs.device)
    for k in range(n_pen):
        v = _boundary_overlap(1, D, ARs.dtype, ARs.device)[0]
        for i in range(L - 1, -1, -1):
            out[k, i + 1] = v
            v = transfer_right(v, ARs_pen[k, i], ARs[i])
        out[k, 0] = v
    return out


def _penalty_vecs(vLs, vRs, ACs_pen):
    """v_k[l,p,r] = vL_k[l,l'] AC_k[l',p,r'] vR_k[r,r']: the local image of
    each penalty state in the current mixed basis, stacked (n_pen, D, d,
    D)."""
    t = torch.einsum("kxy,kypr->kxpr", vLs, ACs_pen)
    return torch.einsum("kxpn,krn->kxpr", t, vRs)


def _penalized_solve(GL, W, GR, AC, vs, weight, m, restarts, inner_tol):
    def mv(x):
        y = ac_apply(GL, W, GR, x)
        ov = torch.einsum("kxpr,xpr->k", vs.conj(), x)
        return y + weight * torch.einsum("k,kxpr->xpr", ov, vs)

    return eigsh_smallest(mv, AC, m, restarts, inner_tol)


def _penalized_sweep(ALs, ARs, AC, Ws, GRs, ALs_pen, ARs_pen, ACs_pen,
                     inner_tol, m: int, restarts: int, weight=10.0):
    """One DMRG sweep of H + weight * sum_k |psi_k><psi_k| (left to right
    over sites 0..L-2, then right to left over L-1..1), on fresh stacks.
    Returns (ALs, ARs, AC, GRs, eigenvalue at site 1)."""
    L, D = ALs.shape[0], ALs.shape[1]
    w = Ws.shape[1]
    dtype, device = AC.dtype, AC.device
    n_pen = ALs_pen.shape[0]
    ALs, ARs = ALs.clone(), ARs.clone()
    vRs = _overlap_right_envs(ARs_pen, ARs)          # (n_pen, L+1, D, D)

    GLs = torch.empty((L, w, D, D), dtype=dtype, device=device)
    vLs_all = torch.empty((L, n_pen, D, D), dtype=dtype, device=device)
    GL = left_boundary(w, D, dtype, device)
    vLs = _boundary_overlap(n_pen, D, dtype, device)
    for i in range(L - 1):
        GLs[i], vLs_all[i] = GL, vLs
        vs = _penalty_vecs(vLs, vRs[:, i + 1], ACs_pen[:, i])
        res = _penalized_solve(GL, Ws[i], GRs[i + 1], AC, vs, weight, m,
                               restarts, inner_tol)
        AL, C = leftorth(res.eigenvector)
        GL = transfer_left_mpo(GL, Ws[i], AL, AL)
        vLs = torch.stack([transfer_left(vLs[k], ALs_pen[k, i], AL)
                           for k in range(n_pen)])
        AC = torch.einsum("lm,mpr->lpr", C, ARs[i + 1])
        ALs[i] = AL
    GLs[L - 1], vLs_all[L - 1] = GL, vLs

    GRs_new = torch.empty((L + 1, w, D, D), dtype=dtype, device=device)
    GR = right_boundary(w, D, dtype, device)
    vRs_c = _boundary_overlap(n_pen, D, dtype, device)
    lam = None
    for i in range(L - 1, 0, -1):
        GRs_new[i + 1] = GR
        vs = _penalty_vecs(vLs_all[i], vRs_c, ACs_pen[:, i])
        res = _penalized_solve(GLs[i], Ws[i], GR, AC, vs, weight, m,
                               restarts, inner_tol)
        C, AR = rightorth(res.eigenvector)
        GR = transfer_right_mpo(GR, Ws[i], AR, AR)
        vRs_c = torch.stack([transfer_right(vRs_c[k], ARs_pen[k, i], AR)
                             for k in range(n_pen)])
        AC = torch.einsum("lpm,mr->lpr", ALs[i - 1], C)
        ARs[i] = AR
        lam = res.eigenvalue
    # GRs[1] is the final carry; GRs[0] is unused and holds the same (as
    # in the JAX package)
    GRs_new[1] = GR
    GRs_new[0] = GR
    return ALs, ARs, AC, GRs_new, lam


def excitations_dmrg(H, alg: FiniteExcited, psi_gs: FiniteMPS, envs=None,
                     num: int = 1, generator=None):
    """`num` excited states above psi_gs by penalized DMRG, each from a
    random start drawn from `generator` (on psi_gs's device; None: a
    generator seeded 7). Returns (energies (num,) CPU tensor, states)."""
    from .expval import expectation_value

    L, D, d = psi_gs.length, psi_gs.D, psi_gs.physicaldim
    dtype, device = psi_gs.dtype, psi_gs.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(7)
    Ws = stack_W(H, L, dtype, device)
    w = Ws.shape[1]
    found = [psi_gs]
    energies = []
    with matmul_precision():
        for _ in range(num):
            gauges = [full_gauges(p) for p in found]
            ALs_pen = torch.stack([g[0] for g in gauges])
            ARs_pen = torch.stack([g[1] for g in gauges])
            # the AC of each penalty state at every site (set-up only)
            ACs_pen = torch.stack([torch.stack(
                [p.move_center(i).AC for i in range(L)]) for p in found])
            psi = FiniteMPS.random(L, d, D, dtype, device, generator)
            GRs = compute_right_envs(psi.ARs, Ws,
                                     right_boundary(w, D, dtype, device))
            ALs, ARs, AC = psi.ALs, psi.ARs, psi.AC
            lam_prev, eps = None, 1.0
            for it in range(1, alg.maxiter + 1):
                inner_tol = updatetol(eps, it)
                ALs, ARs, AC, GRs, lam = _penalized_sweep(
                    ALs, ARs, AC, Ws, GRs, ALs_pen, ARs_pen, ACs_pen,
                    inner_tol, alg.krylovdim, alg.eig_maxrestarts,
                    weight=alg.weight)
                eps = abs(lam - lam_prev) if lam_prev is not None else 1.0
                lam_prev = lam
                if eps < alg.tol:
                    break
            psi = FiniteMPS(ALs, ARs, AC, 0)
            energies.append(float(expectation_value(psi, H)))
            found.append(psi)
    return torch.tensor(energies, dtype=torch.float64), found[1:]
