"""Dynamical DMRG propagators (counterpart of
mpskit_tpu/algorithms/propagator.py).

propagator(psi0, z, H, alg) variationally computes <psi0| (z - H)^{-1}
|psi0> by sweeping GMRES solves of the local system (H_AC - z) AC =
-P(psi0): `NaiveInvert` solves the linear form directly; `Jeckelmann`
solves the quadratic normal equations (H-z)^dag (H-z) AC = -(H - conj(z))
P(psi0), built from the environments of the MPO product H @ H.

The JAX package runs a sweep as one jit-compiled function of two
`lax.scan`s. Here a sweep is a host loop over the sites around the port's
`linsolve` (restarted GMRES with one host read per Arnoldi step), and the
per-site changes are read once at the end of the sweep."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import Defaults, matmul_precision
from ..environments.finite import (
    compute_right_envs, left_boundary, right_boundary, stack_W,
)
from ..linalg.gmres import linsolve
from ..states.finitemps import FiniteMPS
from ..states.quasiparticle import full_gauges
from ..tensors.ops import leftorth, rightorth
from ..transfermatrix.transfer import (
    transfer_left, transfer_left_mpo, transfer_right, transfer_right_mpo,
)
from ..utils.sync import to_host
from .derivatives import ac_apply


@dataclasses.dataclass(frozen=True)
class NaiveInvert:
    pass


@dataclasses.dataclass(frozen=True)
class Jeckelmann:
    pass


@dataclasses.dataclass(frozen=True)
class DynamicalDMRG:
    flavour: object = dataclasses.field(default_factory=NaiveInvert)
    tol: float = 1e-10
    maxiter: int = Defaults.maxiter
    linsolve_tol: float = 1e-10
    verbosity: int = Defaults.verbosity


def _e00(D: int, like):
    v = torch.zeros((D, D), dtype=like.dtype, device=like.device)
    v[0, 0] = 1.0
    return v


def _mixed_right(ARs_t, ARs, Ws, GRL):
    """Right environments with the target as ket and the current state as
    bra: vRs[i] the overlap and GRms[i] the H environment of sites i..L-1
    (vRs[L], GRms[L] the boundaries)."""
    L, D = ARs.shape[0], ARs.shape[1]
    vRs = torch.empty((L + 1, D, D), dtype=ARs.dtype, device=ARs.device)
    GRms = torch.empty((L + 1,) + tuple(GRL.shape), dtype=ARs.dtype,
                       device=ARs.device)
    vRs[L], GRms[L] = _e00(D, ARs), GRL
    for i in range(L - 1, -1, -1):
        vRs[i] = transfer_right(vRs[i + 1], ARs_t[i], ARs[i])
        GRms[i] = transfer_right_mpo(GRms[i + 1], Ws[i], ARs_t[i], ARs[i])
    return vRs, GRms


def _local_solve(z, lin_tol, GL, W, GR, AC, tos, Htos=None, sq=None):
    """Solve the site system from the current AC. sq = (GL2, W2, GR2), the
    H @ H environments, selects the quadratic (Jeckelmann) form."""
    if sq is None:
        return linsolve(lambda x: ac_apply(GL, W, GR, x) - z * x, -tos,
                        x0=AC, a0=0.0, a1=1.0, tol=lin_tol)
    GL2, W2, GR2 = sq
    zz = abs(z) ** 2
    zc = z.conjugate()

    def mv(x):
        return (ac_apply(GL2, W2, GR2, x)
                - (z + zc) * ac_apply(GL, W, GR, x) + zz * x)

    return linsolve(mv, -(Htos - zc * tos), x0=AC, a0=0.0, a1=1.0,
                    tol=lin_tol)


def _ddmrg_sweep(ALs, ARs, AC, Ws, GRs, tgt, z, lin_tol: float,
                 Ws2=None, GR2s=None):
    """One NaiveInvert sweep, or a Jeckelmann one when Ws2 / GR2s (the
    H @ H MPO and its right environments) are given; tgt = (ALs_t, ARs_t,
    ACs_t) of the target |psi0>. Left to right over sites 0..L-2, then
    right to left over L-1..1, starting and ending with center 0. ALs, ARs,
    GRs and GR2s are updated in place and returned with the new center
    tensor and the largest per-site change |AC' - AC| (a host float)."""
    L, D = ALs.shape[0], ALs.shape[1]
    w = Ws.shape[1]
    dtype, device = AC.dtype, AC.device
    quad = Ws2 is not None
    ALs_t, ARs_t, ACs_t = tgt
    vRs, GRms = _mixed_right(ARs_t, ARs, Ws,
                             right_boundary(w, D, dtype, device))
    changes = []

    def tos_at(vL, i, vR):
        return torch.einsum("xy,ypn,rn->xpr", vL, ACs_t[i], vR)

    # ---- left to right: solve sites 0..L-2 ----
    GL = GLm = left_boundary(w, D, dtype, device)
    vL = _e00(D, AC)
    GL2 = left_boundary(Ws2.shape[1], D, dtype, device) if quad else None
    GLs = torch.empty((L, w, D, D), dtype=dtype, device=device)
    GLms = torch.empty_like(GLs)
    vLs = torch.empty((L, D, D), dtype=dtype, device=device)
    GL2s = (torch.empty((L, Ws2.shape[1], D, D), dtype=dtype, device=device)
            if quad else None)
    for i in range(L - 1):
        GLs[i], GLms[i], vLs[i] = GL, GLm, vL
        W = Ws[i]
        tos = tos_at(vL, i, vRs[i + 1])
        Htos = ac_apply(GLm, W, GRms[i + 1], ACs_t[i]) if quad else None
        sq = None
        if quad:
            GL2s[i] = GL2
            sq = (GL2, Ws2[i], GR2s[i + 1])
        ACp = _local_solve(z, lin_tol, GL, W, GRs[i + 1], AC, tos, Htos, sq)
        changes.append(torch.linalg.vector_norm(ACp - AC))
        AL, C = leftorth(ACp)
        GL = transfer_left_mpo(GL, W, AL, AL)
        if quad:
            GL2 = transfer_left_mpo(GL2, Ws2[i], AL, AL)
        GLm = transfer_left_mpo(GLm, W, ALs_t[i], AL)
        vL = transfer_left(vL, ALs_t[i], AL)
        ALs[i] = AL
        AC = torch.einsum("lm,mpr->lpr", C, ARs[i + 1])
    GLs[L - 1], GLms[L - 1], vLs[L - 1] = GL, GLm, vL
    if quad:
        GL2s[L - 1] = GL2

    # ---- right to left: solve sites L-1..1 ----
    GR = GRm = right_boundary(w, D, dtype, device)
    GR2 = right_boundary(Ws2.shape[1], D, dtype, device) if quad else None
    vR = _e00(D, AC)
    for i in range(L - 1, 0, -1):
        GRs[i + 1] = GR
        W = Ws[i]
        tos = tos_at(vLs[i], i, vR)
        Htos = ac_apply(GLms[i], W, GRm, ACs_t[i]) if quad else None
        sq = None
        if quad:
            GR2s[i + 1] = GR2
            sq = (GL2s[i], Ws2[i], GR2)
        ACp = _local_solve(z, lin_tol, GLs[i], W, GR, AC, tos, Htos, sq)
        changes.append(torch.linalg.vector_norm(ACp - AC))
        C, AR = rightorth(ACp)
        GR = transfer_right_mpo(GR, W, AR, AR)
        if quad:
            GR2 = transfer_right_mpo(GR2, Ws2[i], AR, AR)
        GRm = transfer_right_mpo(GRm, W, ARs_t[i], AR)
        vR = transfer_right(vR, ARs_t[i], AR)
        ARs[i] = AR
        AC = torch.einsum("lpm,mr->lpr", ALs[i - 1], C)
    # GRs[0] is unused and repeats GRs[1], as in the JAX package
    GRs[1] = GRs[0] = GR
    if quad:
        GR2s[1] = GR2s[0] = GR2
    return ALs, ARs, AC, GRs, GR2s, max(to_host(*changes))


def _centers(psi: FiniteMPS):
    """(L, D, d, D) stack of psi's center tensor at every site, each in the
    gauge that psi.move_center(i) gives (walked out from psi's center)."""
    ACs = [None] * psi.length
    for sites in (range(psi.center, psi.length), range(psi.center, -1, -1)):
        p = psi
        for i in sites:
            p = p.move_center(i)
            ACs[i] = p.AC
    return torch.stack(ACs)


def propagator(psi0: FiniteMPS, z, H, alg: DynamicalDMRG = DynamicalDMRG(),
               init: Optional[FiniteMPS] = None, device="cuda"):
    """Returns (G, psi) with G = <psi0 | psi> (0-dim tensor) and psi the
    solution of (H - z) psi = -psi0, so that G = <psi0| (z - H)^{-1}
    |psi0>. Runs on `device` (the card unless the caller asks for the CPU;
    psi0 and init move there) in complex128. `init` is the start of the
    sweeps (default psi0)."""
    dtype = torch.complex128

    def _cast(p):
        return FiniteMPS(p.ALs.to(device, dtype), p.ARs.to(device, dtype),
                         p.AC.to(device, dtype), p.center)

    psi0 = _cast(psi0)
    psi = (_cast(init) if init is not None else psi0).move_center(0)
    L, D = psi0.length, psi0.D
    z = complex(z)
    with matmul_precision():
        Ws = stack_W(H, L, dtype, device)
        ALs_t, ARs_t = full_gauges(psi0)
        tgt = (ALs_t, ARs_t, _centers(psi0))
        GRs = compute_right_envs(psi.ARs, Ws,
                                 right_boundary(Ws.shape[1], D, dtype, device))
        Ws2 = GR2s = None
        if isinstance(alg.flavour, Jeckelmann):
            Ws2 = stack_W(H @ H, L, dtype, device)
            GR2s = compute_right_envs(
                psi.ARs, Ws2, right_boundary(Ws2.shape[1], D, dtype, device))
        ALs, ARs, AC = psi.ALs.clone(), psi.ARs.clone(), psi.AC
        for _ in range(alg.maxiter):
            ALs, ARs, AC, GRs, GR2s, eps = _ddmrg_sweep(
                ALs, ARs, AC, Ws, GRs, tgt, z, alg.linsolve_tol, Ws2=Ws2,
                GR2s=GR2s)
            if eps < alg.tol:
                break
        psi = FiniteMPS(ALs, ARs, AC, 0)
        return psi0.dot(psi), psi
